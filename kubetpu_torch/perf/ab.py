"""``python -m kubetpu_torch.perf.ab --other ROOT``: compare this checkout's
scheduling cycle with the checkout at ``ROOT`` on one card, in turns.

    python -m kubetpu_torch.perf.ab --other build/parent \\
        [--case SchedulingBasic:5000Nodes_10000Pods:greedy ...] \\
        [--device cuda] [--rounds K] [--out FILE]

Each run is ``python -m kubetpu_torch.perf`` in a process of its own, started
from its checkout's root, so every run has a fresh interpreter and garbage
collector. For each case the runs go: other, this with the encode cache on,
this with it off, off, on, other — each arm twice, in mirrored order, so a
drift of the card or the host over the call falls on every arm alike. With
``--rounds K`` the runs go instead K times: other, this, this, other (this
on its defaults, the arm ``this``), for K pairs of each arm in turns. The
other checkout runs on its own defaults (it is given no ``--encode-cache``).
Prints one JSON line a run (the runner's result, its arm and its checkout)
and, a case, one line of each arm's pods/s, cycle spans (ms) and seconds
in the garbage collector (this checkout's runs) run by run, with the
card's name and power limit;
``--out`` also writes every line to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CASES = (
    "SchedulingBasic:5000Nodes_10000Pods:greedy",
    "TopologySpreading:5000Nodes_5000Pods:batched",
)
ARMS = ("other", "cache_on", "cache_off", "cache_off", "cache_on", "other")


def run_arm(root: Path, arm: str, case: str, workload: str, engine: str,
            device: str, timeout_s: float) -> dict:
    cmd = [sys.executable, "-m", "kubetpu_torch.perf", "--case", case,
           "--workload", workload, "--engine", engine, "--device", device]
    if arm.startswith("cache_"):
        cmd += ["--encode-cache", "on" if arm == "cache_on" else "off"]
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=timeout_s)
    if out.returncode != 0:
        raise RuntimeError(f"{arm} {case}/{workload} in {root}: exit "
                           f"{out.returncode}\n{out.stderr[-4000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {"arm": arm, "root": str(root), **res}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kubetpu_torch.perf.ab")
    ap.add_argument("--other", required=True,
                    help="root of the checkout to hold this one against")
    ap.add_argument("--case", action="append",
                    help="CASE:WORKLOAD:ENGINE (default: %s)" % ", ".join(CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=0,
                    help="run K rounds of other, this, this, other instead "
                         "of the encode-cache arms")
    ap.add_argument("--out", help="also write every line to this file")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a run may take")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parents[2]
    other = Path(args.other).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip() if args.device != "cpu" else "cpu"
    arms = ("other", "this", "this", "other") * args.rounds if args.rounds else ARMS
    lines = []
    for spec in args.case or CASES:
        case, workload, engine = spec.split(":")
        runs = []
        for arm in arms:
            root = other if arm == "other" else here
            runs.append(run_arm(root, arm, case, workload, engine, args.device,
                                args.timeout))
            lines.append(runs[-1])
            print(json.dumps(runs[-1]), flush=True)
        summary = {"ab": f"{case}/{workload}", "engine": engine, "card": card, "arms": {
            arm: {
                "pods_per_s": [r["pods_per_s"] for r in runs if r["arm"] == arm],
                "cycle_ms": [r["cycle_ms"] for r in runs if r["arm"] == arm],
                "gc_s": [r.get("gc_s") for r in runs if r["arm"] == arm],
            } for arm in dict.fromkeys(arms)
        }}
        lines.append(summary)
        print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
