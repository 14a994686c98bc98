"""``python -m kubetpu_torch.perf``: run one scheduler_perf workload in
direct mode and print its result as one JSON line.

    python -m kubetpu_torch.perf --case SchedulingBasic \\
        --workload 5000Nodes_10000Pods [--engine greedy|batched|packing] \\
        [--device cuda] [--max-batch 1024] [--pipeline on|off] \\
        [--encode-cache on|off] [--flight-recorder on|off] [--mesh off|auto|on]
    python -m kubetpu_torch.perf --case SchedulingPodAffinity \\
        --workload 5000Nodes_5000Pods --engine batched
    python -m kubetpu_torch.perf --case TopologySpreading \\
        --workload 5000Nodes_5000Pods --engine batched
    python -m kubetpu_torch.perf --case PreemptionAsync --workload 5000Nodes
    python -m kubetpu_torch.perf --case BinPacking \\
        --workload 1000Nodes_3000Pods --engine packing
"""

from __future__ import annotations

import argparse
import json

from . import TEST_CASES, run_workload


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m kubetpu_torch.perf")
    ap.add_argument("--case", default="SchedulingBasic", choices=sorted(TEST_CASES))
    ap.add_argument("--workload", default="5000Nodes_10000Pods")
    ap.add_argument("--engine", default="greedy", choices=("greedy", "batched", "packing"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--pipeline", default="off", choices=("on", "off"),
                    help="two-stage pipelined cycles (bindings identical to "
                         "the serial loop's)")
    ap.add_argument("--encode-cache", default="on", choices=("on", "off"),
                    help="event-time template-keyed pod encoding (bit-"
                         "identical to a fresh encode; 'off' to debug)")
    ap.add_argument("--flight-recorder", default="on", choices=("on", "off"),
                    help="per-pod decision records with the cycle-start "
                         "breakdown (the explain kernels); 'off' is the "
                         "overhead escape hatch")
    ap.add_argument("--mesh", default="off", choices=("off", "auto", "on"),
                    help="shard the node axis over the device type's devices "
                         "(a power of two of them; 'on' requires two)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    res = run_workload(
        args.case, args.workload, device=args.device,
        max_batch=args.max_batch, engine=args.engine,
        pipeline=args.pipeline == "on",
        encode_cache=args.encode_cache == "on",
        flight_recorder=args.flight_recorder == "on",
        mesh=args.mesh,
    )
    print(json.dumps(res.to_json()))
    return 0 if res.scheduled == res.measure_pods else 1


if __name__ == "__main__":
    raise SystemExit(main())
