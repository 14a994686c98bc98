# Port copy of kubetpu/state/dra.py, verbatim apart from this note (no JAX in it).
"""Dynamic Resource Allocation — tensorization + host allocator.

Reference surfaces mirrored:

- ``pkg/scheduler/framework/plugins/dynamicresources/dynamicresources.go``:
  PreEnqueue (claims must exist :270), PreFilter claim/class validation
  (:444, :668), Filter = "can every unallocated claim be allocated on this
  node" (:734), Reserve allocates in-memory (:1146), Unreserve rolls back
  (:1255), PreBind writes claim status (:1334), Score rewards earlier
  prioritized-list alternatives (:1059 computeScore).
- ``staging/src/k8s.io/dynamic-resource-allocation/structured/allocator.go``:
  the exact device allocator (selectors, ExactCount/All, matchAttribute
  constraints, firstAvailable).

TPU-native split — the design insight is that the perf-critical shape
(claim templates stamping identical single-device claims over node-local
pools, ``dra/performance-config.yaml``) is *exactly* a resource-fit
problem, so it folds into the machinery the engines already capacity-couple:

1. **Dense pools** (device path): a distinct (deviceClass, selector-set)
   over node-local interchangeable devices interns to a *pool column*
   appended to the batch's resource axis. Node capacity = matching devices
   on the node's slices; node "requested" = already-allocated matching
   devices; pod request = claim count. The greedy scan / batched rounds then
   enforce in-batch device contention exactly like CPU/memory — no new
   kernel.
2. **Host claims** (everything dense can't express): All-mode, constraints,
   prioritized lists, and network-attached devices get a per-spec
   ``(N,)`` feasibility mask from the exact host allocator (evaluated once
   per distinct claim spec, not per pod). In-batch conflicts on these are
   resolved optimistically: Reserve re-runs the exact allocator against the
   live cache and a losing pod is forgotten + requeued (the reference's
   assume-then-fail path), converging next cycle.

Known deviation: preemption's victim search does not model freed devices
(a victim's claim deallocates via its delete event, next cycle); the
reference's DRA PostFilter special-case (:923) is likewise out of the
dry-run kernel's scope.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import Iterable, Sequence

import numpy as np

from ..api import types as t

# --------------------------------------------------------------------------
# CEL subset
# --------------------------------------------------------------------------


class CelUnsupportedError(ValueError):
    """Raised for CEL device selectors outside the structured subset —
    surfaced as a claim/class validation failure (the reference fails the
    claim on CEL compile errors, dynamicresources.go:668)."""


# one comparison term: device.driver or device.attributes["..."](.name)?
_DRIVER_RE = re.compile(
    r'^device\.driver\s*(==|!=)\s*"([^"]*)"$'
)
_ATTR_RE = re.compile(
    r'^device\.attributes\["([^"\]]+)"\](?:\.([A-Za-z_]\w*))?'
    r'\s*(==|!=|>=|<=|>|<)\s*(.+)$'
)
_CAP_RE = re.compile(
    r'^device\.capacity\["([^"\]]+)"\](?:\.([A-Za-z_]\w*))?'
    r'\s*(==|!=|>=|<=|>|<)\s*(.+)$'
)


def _parse_literal(text: str):
    text = text.strip()
    if text.startswith('"') and text.endswith('"') and len(text) >= 2:
        return text[1:-1]
    if text in ("true", "false"):
        return text == "true"
    try:
        return int(text)
    except ValueError:
        raise CelUnsupportedError(f"unsupported CEL literal: {text!r}")


def parse_cel(expression: str) -> tuple[tuple[str, str, str, object], ...]:
    """Parse the structured subset: conjunctions (&&) of comparisons on
    ``device.driver``, ``device.attributes["qualified.name"]`` (optionally
    ``["domain"].name``) and ``device.capacity[...]``. Returns canonical
    terms ``(field, key, op, literal)``; raises CelUnsupportedError
    otherwise."""
    terms: list[tuple[str, str, str, object]] = []
    for part in expression.split("&&"):
        part = part.strip()
        if part.startswith("(") and part.endswith(")"):
            part = part[1:-1].strip()
        m = _DRIVER_RE.match(part)
        if m:
            terms.append(("driver", "", m.group(1), m.group(2)))
            continue
        m = _ATTR_RE.match(part)
        if m:
            dom, name, op, lit = m.groups()
            key = f"{dom}.{name}" if name else dom
            terms.append(("attr", key, op, _parse_literal(lit)))
            continue
        m = _CAP_RE.match(part)
        if m:
            dom, name, op, lit = m.groups()
            key = f"{dom}.{name}" if name else dom
            terms.append(("cap", key, op, _parse_literal(lit)))
            continue
        raise CelUnsupportedError(
            f"CEL expression outside the structured subset: {part!r}"
        )
    return tuple(terms)


def _cmp(op: str, a, b) -> bool:
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    try:
        if op == ">=":
            return a >= b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == "<":
            return a < b
    except TypeError:
        return False
    return False


def _device_matches(
    terms: Iterable[tuple[str, str, str, object]],
    driver: str,
    device: t.Device,
) -> bool:
    attrs = None
    caps = None
    for field, key, op, lit in terms:
        if field == "driver":
            if not _cmp(op, driver, lit):
                return False
        elif field == "attr":
            if attrs is None:
                attrs = dict(device.attributes)
            val = attrs.get(key)
            if val is None or not _cmp(op, val, lit):
                # missing attribute: a CEL runtime error excludes the device
                return False
        else:  # cap
            if caps is None:
                caps = dict(device.capacity)
            val = caps.get(key)
            if val is None or not _cmp(op, val, lit):
                return False
    return True


def _selector_sig(selectors: Sequence[t.CELSelector]) -> tuple:
    """Canonical, hashable signature of a selector list (parsed terms).
    Raises CelUnsupportedError for unparseable expressions."""
    out = []
    for sel in selectors:
        out.extend(parse_cel(sel.expression))
    return tuple(sorted(out, key=repr))


# --------------------------------------------------------------------------
# The cache-resident index
# --------------------------------------------------------------------------

_DevKey = tuple[str, str, str]  # (driver, pool, device name)


@dataclass
class _Pool:
    """One interned dense pool: a deviceClass plus extra request selectors."""

    class_name: str
    extra_terms: tuple
    gen: int = -1                 # generation the caches below were built at
    dense_ok: bool = True         # False once a matching network device seen
    valid: bool = True            # False when the class is missing/bad CEL
    cap: dict[str, int] | None = None     # node -> matching device count
    alloc: dict[str, int] | None = None   # node -> allocated matching count


class DraIndex:
    """Single-owner (scheduler loop thread) DRA state: the class/slice/claim
    listers plus the pool interner and allocated-device bookkeeping. Lives on
    the Cache; snapshots share the reference (encode and Reserve both run on
    the loop thread, like the volume listers)."""

    def __init__(self) -> None:
        self.device_classes: dict[str, t.DeviceClass] = {}
        self.slices: dict[str, t.ResourceSlice] = {}
        self.claims: dict[str, t.ResourceClaim] = {}
        self.generation = 0          # bumped on slice/class topology changes
        # bumped on claim add/remove/update — cheap change signal for the
        # pipelined scheduler's staleness check (claim churn must not
        # invalidate the pool catalogs the way `generation` does)
        self.claims_version = 0
        self._class_terms: dict[str, tuple | None] = {}  # None = bad CEL
        self._pool_ids: dict[tuple, int] = {}
        self._pools: list[_Pool] = []
        # (gen, {(driver,pool,dev): (node_name|'', all_nodes, node_sel, Device, driver)})
        self._catalog: tuple[int, dict] | None = None
        self.allocated_devices: dict[str, set[_DevKey]] = {}  # node ('' = net)

    # ---- listers / mutators ---------------------------------------------
    def add_class(self, dc: t.DeviceClass) -> None:
        self.device_classes[dc.name] = dc
        self._class_terms.pop(dc.name, None)
        self.generation += 1

    def remove_class(self, name: str) -> None:
        if self.device_classes.pop(name, None) is not None:
            self._class_terms.pop(name, None)
            self.generation += 1

    def add_slice(self, sl: t.ResourceSlice) -> None:
        self.slices[sl.name] = sl
        self.generation += 1

    def remove_slice(self, name: str) -> None:
        if self.slices.pop(name, None) is not None:
            self.generation += 1

    def add_claim(self, claim: t.ResourceClaim) -> None:
        old = self.claims.get(claim.key)
        self.claims[claim.key] = claim
        self.claims_version += 1
        self._reconcile_allocation(old, claim)

    def remove_claim(self, key: str) -> None:
        old = self.claims.pop(key, None)
        if old is not None:
            self.claims_version += 1
            self._reconcile_allocation(old, None)

    # ---- allocation bookkeeping -----------------------------------------
    def _reconcile_allocation(
        self, old: t.ResourceClaim | None, new: t.ResourceClaim | None
    ) -> None:
        old_a = old.allocation if old is not None else None
        new_a = new.allocation if new is not None else None
        if old_a is new_a or (old_a == new_a):
            return
        if old_a is not None:
            self._release(old_a)
        if new_a is not None:
            self._consume(new_a)

    def _dev_keys(self, alloc: t.ClaimAllocation) -> list[_DevKey]:
        return [(r.driver, r.pool, r.device) for r in alloc.results]

    def _home(self, key: _DevKey, cat: dict, fallback: str) -> str:
        """Accounting bucket for a device: its slice's node for node-local
        devices, '' (global) for network-attached ones — a network device
        consumed from one node is unavailable from EVERY node."""
        entry = cat.get(key)
        if entry is None:
            return fallback
        node = entry[0]
        return node if node else ""

    def _consume(self, alloc: t.ClaimAllocation) -> None:
        cat = self._ensure_catalog()
        for key in self._dev_keys(alloc):
            bucket = self._home(key, cat, alloc.node_name)
            s = self.allocated_devices.setdefault(bucket, set())
            if key in s:
                continue
            s.add(key)
            self._charge_pools(bucket, key, cat, +1)

    def _release(self, alloc: t.ClaimAllocation) -> None:
        cat = self._ensure_catalog()
        for key in self._dev_keys(alloc):
            bucket = self._home(key, cat, alloc.node_name)
            s = self.allocated_devices.get(bucket)
            if s is not None and key in s:
                s.discard(key)
                self._charge_pools(bucket, key, cat, -1)
                if not s:
                    self.allocated_devices.pop(bucket, None)

    def _charge_pools(self, node: str, key: _DevKey, cat: dict, delta: int) -> None:
        """Keep already-built pool alloc counts incremental (stale pools
        rebuild from scratch on demand, so only current-gen pools matter)."""
        entry = cat.get(key)
        if entry is None:
            return
        _node, _all, _sel, device, driver = entry
        for pool in self._pools:
            if pool.gen != self.generation or pool.alloc is None:
                continue
            if self._pool_device_matches(pool, driver, device):
                pool.alloc[node] = pool.alloc.get(node, 0) + delta
                if pool.alloc[node] <= 0:
                    pool.alloc.pop(node, None)

    # ---- pool interning / evaluation ------------------------------------
    def class_terms(self, name: str) -> tuple | None:
        """Parsed selector terms for a class; None when the class is missing
        or its CEL is outside the subset (claim then blocks, :668)."""
        if name in self._class_terms:
            return self._class_terms[name]
        dc = self.device_classes.get(name)
        terms: tuple | None
        if dc is None:
            return None  # missing class is not cached — it may appear later
        try:
            terms = _selector_sig(dc.selectors)
        except CelUnsupportedError:
            terms = None
        self._class_terms[name] = terms
        return terms

    def intern_pool(
        self, class_name: str, selectors: Sequence[t.CELSelector]
    ) -> int:
        """Pool id for (deviceClass, request selectors); stable across the
        index's lifetime so the batch resource axis stays cycle-stable."""
        try:
            extra = _selector_sig(selectors)
        except CelUnsupportedError:
            extra = None
        key = (class_name, extra)
        pid = self._pool_ids.get(key)
        if pid is None:
            pid = len(self._pools)
            self._pool_ids[key] = pid
            # extra_terms None = unparseable request CEL: the pool stays
            # permanently invalid (ensure_pool re-derives valid from it, so
            # the marker must survive interning)
            self._pools.append(
                _Pool(class_name=class_name, extra_terms=extra)
            )
        return pid

    def _pool_device_matches(
        self, pool: _Pool, driver: str, device: t.Device
    ) -> bool:
        if pool.extra_terms is None:
            return False   # unparseable request CEL — matches nothing
        cls_terms = self.class_terms(pool.class_name)
        if cls_terms is None:
            return False
        return _device_matches(cls_terms, driver, device) and _device_matches(
            pool.extra_terms, driver, device
        )

    def _ensure_catalog(self) -> dict:
        if self._catalog is not None and self._catalog[0] == self.generation:
            return self._catalog[1]
        cat: dict = {}
        for sl in self.slices.values():
            for dev in sl.devices:
                cat[(sl.driver, sl.pool, dev.name)] = (
                    sl.node_name, sl.all_nodes, sl.node_selector, dev, sl.driver
                )
        self._catalog = (self.generation, cat)
        self._rebucket(cat)
        return cat

    def _rebucket(self, cat: dict) -> None:
        """Claims can be observed before their slices (informer start order
        is best-effort; a relist can interleave kinds): a device consumed
        against an empty catalog lands in the claim's ``node_name`` bucket.
        On every catalog regeneration, re-derive each allocated device's
        home so network-attached devices migrate to the global ``''``
        bucket — otherwise other nodes still see the device free (double
        allocation) and a later ``_release`` misses the stale entry,
        leaking it as permanently allocated."""
        moved: dict[str, set[_DevKey]] = {}
        for bucket, keys in self.allocated_devices.items():
            for key in keys:
                home = self._home(key, cat, bucket)
                moved.setdefault(home, set()).add(key)
        self.allocated_devices = {b: s for b, s in moved.items() if s}

    def ensure_pool(self, pid: int) -> _Pool:
        pool = self._pools[pid]
        if pool.gen == self.generation:
            return pool
        pool.valid = (
            pool.extra_terms is not None
            and self.class_terms(pool.class_name) is not None
            and pool.class_name in self.device_classes
        )
        cap: dict[str, int] = {}
        dense_ok = True
        cat = self._ensure_catalog()
        if pool.valid:
            for (driver, _p, _d), entry in cat.items():
                node, all_nodes, node_sel, device, drv = entry
                if not self._pool_device_matches(pool, drv, device):
                    continue
                if all_nodes or node_sel is not None or not node:
                    dense_ok = False
                    continue
                cap[node] = cap.get(node, 0) + 1
        alloc: dict[str, int] = {}
        for node, keys in self.allocated_devices.items():
            for key in keys:
                entry = cat.get(key)
                if entry is None:
                    continue
                if self._pool_device_matches(pool, entry[4], entry[3]):
                    alloc[node] = alloc.get(node, 0) + 1
        pool.cap = cap
        pool.alloc = alloc
        pool.dense_ok = dense_ok
        pool.gen = self.generation
        return pool

    # ---- exact host allocator -------------------------------------------
    def node_free_devices(
        self, node_name: str, node_labels: dict | None = None,
        taken: set[_DevKey] | None = None,
    ) -> list[tuple[_DevKey, str, t.Device]]:
        """Free concrete devices usable from ``node_name``: the node's local
        slices plus all-nodes / matching node-selector slices, minus
        allocated devices (node-pinned and network), minus ``taken``.
        Deterministic order (sorted key)."""
        from ..state.volumes import node_affinity_matches

        cat = self._ensure_catalog()
        allocated: set[_DevKey] = set()
        allocated.update(self.allocated_devices.get(node_name, ()))
        allocated.update(self.allocated_devices.get("", ()))
        if taken:
            allocated.update(taken)
        out = []
        for key in sorted(cat):
            node, all_nodes, node_sel, device, driver = cat[key]
            if key in allocated:
                continue
            if node:
                if node != node_name:
                    continue
            elif all_nodes:
                pass
            elif node_sel is not None:
                if not node_affinity_matches(
                    node_sel, node_labels or {}, node_name
                ):
                    continue
            else:
                continue
            out.append((key, driver, device))
        return out

    def allocate_on_node(
        self,
        claims: Sequence[t.ResourceClaim],
        node_name: str,
        node_labels: dict | None = None,
    ) -> list[t.ClaimAllocation] | None:
        """The structured allocator (allocator.go semantics, deterministic
        first-fit): try to satisfy every claim's requests from the node's
        free devices. Returns one ClaimAllocation per claim or None."""
        free = self.node_free_devices(node_name, node_labels)
        taken: set[_DevKey] = set()
        allocations: list[t.ClaimAllocation] = []
        for claim in claims:
            results = self._allocate_claim(claim, node_name, free, taken)
            if results is None:
                return None
            allocations.append(
                t.ClaimAllocation(node_name=node_name, results=tuple(results))
            )
        return allocations

    def _candidates(
        self, class_name: str, selectors, free, taken: set[_DevKey]
    ) -> list[tuple[_DevKey, str, t.Device]] | None:
        cls_terms = self.class_terms(class_name)
        if cls_terms is None or class_name not in self.device_classes:
            return None
        try:
            extra = _selector_sig(selectors)
        except CelUnsupportedError:
            return None
        return [
            (key, driver, dev)
            for key, driver, dev in free
            if key not in taken
            and _device_matches(cls_terms, driver, dev)
            and _device_matches(extra, driver, dev)
        ]

    def _allocate_claim(
        self,
        claim: t.ResourceClaim,
        node_name: str,
        free,
        taken: set[_DevKey],
    ) -> list[t.DeviceResult] | None:
        """Allocate one claim; on success, consumed keys join ``taken``.
        Constraints (matchAttribute) retry over candidate attribute values,
        smallest value first, matching the allocator's deterministic
        backtracking."""
        constraint_attrs = [
            (c.match_attribute, set(c.requests)) for c in claim.constraints
        ]

        def pick(attr_pin: dict[str, object]) -> list[t.DeviceResult] | None:
            picked: list[t.DeviceResult] = []
            local_taken: set[_DevKey] = set()

            def req_candidates(names, class_name, selectors):
                """``names``: every name this request answers to for
                constraint membership — the parent request name AND (for a
                prioritized-list alternative) the "parent/sub" form, per
                resource.k8s.io/v1: a constraint naming the main request
                covers its subrequests."""
                cands = self._candidates(class_name, selectors, free, taken)
                if cands is None:
                    return None
                out = []
                for key, driver, dev in cands:
                    if key in local_taken:
                        continue
                    ok = True
                    for attr, reqs in constraint_attrs:
                        if reqs and reqs.isdisjoint(names):
                            continue
                        pin = attr_pin.get(attr)
                        if pin is not None and dev.attributes_dict().get(attr) != pin:
                            ok = False
                            break
                    if ok:
                        out.append((key, driver, dev))
                return out

            def take(req_name, cands, count, all_devices) -> bool:
                if all_devices:
                    if not cands:
                        return False
                    chosen = cands
                else:
                    if len(cands) < count:
                        return False
                    chosen = cands[:count]
                for key, driver, dev in chosen:
                    local_taken.add(key)
                    picked.append(t.DeviceResult(
                        request=req_name, driver=key[0], pool=key[1],
                        device=key[2],
                    ))
                return True

            for req in claim.requests:
                if req.first_available:
                    done = False
                    for i, sub in enumerate(req.first_available):
                        full = f"{req.name}/{sub.name}"
                        cands = req_candidates(
                            {req.name, full},
                            sub.device_class_name, sub.selectors,
                        )
                        if cands and take(full, cands, sub.count, False):
                            done = True
                            break
                    if not done:
                        return None
                else:
                    cands = req_candidates(
                        {req.name}, req.device_class_name, req.selectors
                    )
                    if cands is None or not take(
                        req.name, cands, req.count, req.all_devices
                    ):
                        return None
            taken.update(local_taken)
            return picked

        if not constraint_attrs:
            return pick({})
        # matchAttribute backtracking: each constrained attribute pins
        # INDEPENDENTLY to one of its observed values; try the product of
        # value choices, sorted for determinism, first full assignment wins
        # (allocator.go's per-constraint backtracking)
        import itertools

        attrs = sorted({a for a, _ in constraint_attrs})
        per_attr_values: list[list[object]] = []
        for attr in attrs:
            seen: set[str] = set()
            values: list[object] = []
            for key, driver, dev in free:
                if key in taken:
                    continue
                v = dev.attributes_dict().get(attr)
                if v is not None and repr(v) not in seen:
                    seen.add(repr(v))
                    values.append(v)
            if not values:
                return None
            per_attr_values.append(sorted(values, key=repr))
        for combo in itertools.product(*per_attr_values):
            res = pick(dict(zip(attrs, combo)))
            if res is not None:
                return res
        return None

    # ---- claim status transitions (Reserve / Unreserve / informers) -----
    def set_allocation(
        self, key: str, alloc: t.ClaimAllocation, pod_uid: str
    ) -> None:
        claim = self.claims[key]
        new = replace(
            claim, allocation=alloc,
            reserved_for=claim.reserved_for + (pod_uid,),
        )
        self.claims[key] = new
        self._reconcile_allocation(claim, new)

    def clear_allocation(self, key: str) -> None:
        claim = self.claims.get(key)
        if claim is None or claim.allocation is None:
            return
        new = replace(claim, allocation=None, reserved_for=())
        self.claims[key] = new
        self._reconcile_allocation(claim, new)

    def release_claim(self, key: str, pod_uid: str) -> bool:
        """Unreserve semantics for a pod that triggered the allocation: drop
        the pod's reservedFor entry; deallocate only when NO other pod still
        holds a reservation (another sharer may have reserved the same claim
        this cycle — its allocation must survive). Returns True when the
        claim was actually deallocated."""
        claim = self.claims.get(key)
        if claim is None:
            return False
        remaining = tuple(u for u in claim.reserved_for if u != pod_uid)
        if remaining:
            self.claims[key] = replace(claim, reserved_for=remaining)
            return False
        if claim.allocation is None:
            if remaining != claim.reserved_for:
                self.claims[key] = replace(claim, reserved_for=remaining)
            return False
        new = replace(claim, allocation=None, reserved_for=())
        self.claims[key] = new
        self._reconcile_allocation(claim, new)
        return True

    def add_reserved(self, key: str, pod_uid: str) -> None:
        claim = self.claims.get(key)
        if claim is not None and pod_uid not in claim.reserved_for:
            self.claims[key] = replace(
                claim, reserved_for=claim.reserved_for + (pod_uid,)
            )

    def remove_reserved(self, key: str, pod_uid: str) -> None:
        claim = self.claims.get(key)
        if claim is not None and pod_uid in claim.reserved_for:
            self.claims[key] = replace(
                claim,
                reserved_for=tuple(
                    u for u in claim.reserved_for if u != pod_uid
                ),
            )


# --------------------------------------------------------------------------
# Per-encode view
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PodDra:
    """Per-pod DRA analysis, all hashable (joins the encoder's signature
    machinery)."""

    blocked: bool = False
    # rejected-by reason for PreEnqueue-style waits ('' = schedulable path)
    pin: str | None = None            # node the pod must land on (allocated)
    dense: tuple[tuple[int, int], ...] = ()   # (pool id, count)
    host_specs: tuple = ()            # claim-spec sigs needing host masks

    @property
    def sig(self) -> tuple:
        return (self.blocked, self.pin, self.dense, self.host_specs)

    @property
    def any_work(self) -> bool:
        return (
            self.blocked or self.pin is not None
            or bool(self.dense) or bool(self.host_specs)
        )


def _claim_spec_sig(claim: t.ResourceClaim) -> tuple:
    return (claim.requests, claim.constraints)


class DraState:
    """Per-encode DRA view (the VolumeState analog): resolves pods' claims
    into dense pool requests + static contributions, and computes host-path
    feasibility masks once per distinct claim spec."""

    def __init__(self, snapshot) -> None:
        self.index: DraIndex = snapshot.dra
        self.snapshot = snapshot
        self._pod_cache: dict[tuple, PodDra] = {}
        self._spec_masks: dict[tuple, np.ndarray] = {}
        self._spec_scores: dict[tuple, np.ndarray | None] = {}
        self.used_pools: set[int] = set()

    # ---- analysis --------------------------------------------------------
    def analyze(self, pod: t.Pod) -> PodDra:
        claim_keys = tuple(
            f"{pod.namespace}/{rc.claim_name}"
            for rc in pod.resource_claims if rc.claim_name
        )
        if not claim_keys:
            return PodDra()
        cache_key = (claim_keys, pod.uid)
        got = self._pod_cache.get(cache_key)
        if got is not None:
            return got
        idx = self.index
        pins: set[str] = set()
        dense: dict[int, int] = {}
        host: list[tuple] = []
        blocked = False
        for key in claim_keys:
            claim = idx.claims.get(key)
            if claim is None:
                blocked = True            # PreEnqueue: claim not created yet
                break
            if claim.allocation is not None:
                if (
                    pod.uid not in claim.reserved_for
                    and len(claim.reserved_for) >= t.RESERVED_FOR_MAX
                ):
                    blocked = True
                    break
                if claim.allocation.node_name:
                    pins.add(claim.allocation.node_name)
                continue
            spec_dense = self._spec_dense(claim)
            if spec_dense is None:
                host.append(_claim_spec_sig(claim))
            elif spec_dense == "blocked":
                blocked = True
                break
            else:
                for pid, count in spec_dense:
                    dense[pid] = dense.get(pid, 0) + count
                    self.used_pools.add(pid)
        if len(pins) > 1:
            blocked = True
        res = PodDra(
            blocked=blocked,
            pin=(next(iter(pins)) if pins and not blocked else None),
            dense=tuple(sorted(dense.items())) if not blocked else (),
            host_specs=tuple(host) if not blocked else (),
        )
        self._pod_cache[cache_key] = res
        return res

    def _spec_dense(self, claim: t.ResourceClaim):
        """Dense pool items for a claim spec, or None (host path) or
        'blocked' (invalid class / bad CEL, :668 validateDeviceClass)."""
        if claim.constraints:
            return None
        items: list[tuple[int, int]] = []
        for req in claim.requests:
            if req.first_available or req.all_devices:
                return None
            if not req.device_class_name:
                return "blocked"
            if idx_terms_invalid(self.index, req.device_class_name):
                return "blocked"
            pid = self.index.intern_pool(req.device_class_name, req.selectors)
            pool = self.index.ensure_pool(pid)
            if not pool.valid:
                return "blocked"
            if not pool.dense_ok:
                return None
            items.append((pid, req.count))
        return items

    # ---- host-path masks / scores ---------------------------------------
    def _node_labels(self, nt) -> list[dict]:
        return [info.node.labels_dict() for info in nt.infos]

    def spec_mask(self, spec_sig: tuple, nt) -> np.ndarray:
        """(N,) bool: nodes where the exact allocator can place a claim with
        this spec against the CURRENT allocations (no in-batch coupling —
        Reserve re-verifies)."""
        m = self._spec_masks.get(spec_sig)
        if m is not None:
            return m
        requests, constraints = spec_sig
        probe = t.ResourceClaim(
            name="?", requests=requests, constraints=constraints
        )
        N = nt.num_nodes
        m = np.zeros(N, dtype=bool)
        labels = self._node_labels(nt)
        for i, name in enumerate(nt.node_names):
            if self.index.allocate_on_node([probe], name, labels[i]) is not None:
                m[i] = True
        self._spec_masks[spec_sig] = m
        return m

    def spec_score(self, spec_sig: tuple, nt) -> np.ndarray | None:
        """(N,) int64 prioritized-list raw score (computeScore :1087):
        Σ over firstAvailable requests of (FIRST_AVAILABLE_MAX - chosen
        alternative index) on each feasible node. None when the spec has no
        prioritized lists."""
        if spec_sig in self._spec_scores:
            return self._spec_scores[spec_sig]
        requests, constraints = spec_sig
        if not any(r.first_available for r in requests):
            self._spec_scores[spec_sig] = None
            return None
        probe = t.ResourceClaim(
            name="?", requests=requests, constraints=constraints
        )
        N = nt.num_nodes
        out = np.zeros(N, dtype=np.int64)
        labels = self._node_labels(nt)
        for i, name in enumerate(nt.node_names):
            allocs = self.index.allocate_on_node([probe], name, labels[i])
            if allocs is None:
                continue
            chosen = {r.request for r in allocs[0].results}
            s = 0
            for req in requests:
                for j, sub in enumerate(req.first_available):
                    if f"{req.name}/{sub.name}" in chosen:
                        s += t.FIRST_AVAILABLE_MAX - j
                        break
            out[i] = s
        self._spec_scores[spec_sig] = out
        return out

    # ---- dense columns ---------------------------------------------------
    def pool_columns(self) -> list[int]:
        """Stable column order for this batch's dense pools."""
        return sorted(self.used_pools)

    def pool_resource_names(self) -> list[str]:
        return [f"dra/pool{pid}" for pid in self.pool_columns()]

    def fill_node_columns(self, nt, first_col: int) -> None:
        """Write pool capacity/allocated into the node tensors' appended
        columns (cheap per cycle: O(nodes-with-devices), overwritten
        unconditionally so incremental row reuse stays correct)."""
        name_to_idx = {n: i for i, n in enumerate(nt.node_names)}
        for j, pid in enumerate(self.pool_columns()):
            pool = self.index.ensure_pool(pid)
            col = first_col + j
            nt.alloc[:, col] = 0
            nt.requested[:, col] = 0
            nt.nonzero_requested[:, col] = 0
            for node, cap in (pool.cap or {}).items():
                i = name_to_idx.get(node)
                if i is not None:
                    nt.alloc[i, col] = cap
            for node, used in (pool.alloc or {}).items():
                i = name_to_idx.get(node)
                if i is not None:
                    nt.requested[i, col] = used
                    nt.nonzero_requested[i, col] = used


def idx_terms_invalid(index: DraIndex, class_name: str) -> bool:
    """True when the class exists but its CEL is unparseable (permanently
    blocked); a *missing* class is handled as blocked-until-add upstream."""
    if class_name not in index.device_classes:
        return False
    return index.class_terms(class_name) is None
