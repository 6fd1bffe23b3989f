"""Context bootstrap planning: the FetchSource ladder, bandwidth-aware
admission, and measured-transfer calibration.

Port of ``repro.core.transfer``: framework-free, a copy with its imports
pointed at this package.

The paper's insight (§1, §4.1): when many opportunistic workers arrive at
once, cold-starting them all from the shared filesystem saturates it (the
cluster's Panasas sustains ~84 Gb/s TOTAL); instead, workers that already
hold the context template serve it peer-to-peer, so aggregate bootstrap
bandwidth scales with the number of warm donors.

In this package's in-process runtime, "P2P" is a donor engine's template
copied to host tensors and restored onto the receiver's device — same
planning math, different wires.

The FetchSource ladder
----------------------
Every context acquisition — live or simulated — is one of five sources::

    PEER   donor->receiver snapshot transfer from a warm worker that holds
           the materialized context (template export; the donor keeps
           serving). Gated by per-donor fanout + bandwidth admission.
    POOL   promotion of a HOST_RAM snapshot from the node SnapshotPool
           (one host->HBM transfer; the snapshot is consumed).
    DISK   promotion of a LOCAL_DISK spill (npz read + host->HBM).
    FS     cold fetch of the artifact + env from the shared filesystem
           (modeled bandwidth in simulation; in-process the builder's own
           load path plays this role).
    BUILD  pure construction from scratch — no artifact to transfer.

Selection is COST-BASED, not fixed-priority: the scheduler scores every
feasible rung in predicted seconds — peer bandwidth at the donor's current
fanout share, pool/disk promotion over the receiving worker's own PCIe
link, the shared-FS share at the current contention level plus the cold
load, and a modeled build/compile cost — and picks the cheapest. The
EWMA-calibrated bandwidths from :meth:`TransferPlanner.complete` feed the
scores, so a donor that measured slow genuinely loses to a local NVMe
restore. The canonical order above (PEER > POOL > DISK > FS > BUILD) is
what the *uncalibrated* defaults produce for a paper-size context, and
remains the deterministic tie-break when two rungs predict equal seconds.

The :class:`~repro.core.scheduler.ContextAwareScheduler` owns the ladder
POLICY (``_choose_source``); this module owns the timing/admission MATH —
both the side-effect-free prediction surface (``peer_seconds``,
``cold_seconds``, ``build_seconds``, ``restore_seconds``) the chooser
scores with, and the flow-registering commit surface (``peer_plan``,
``fs_plan``, ``pool_plan``). Both execution backends (live PCMManager,
discrete-event simulator) speak the same vocabulary, which is what lets
one policy object drive both.

Live flows report their **measured** duration back through
:meth:`TransferPlanner.complete`, which (a) prunes the modeled flow the
moment the real transfer finishes — without this, long-lived modeled flows
make donors look saturated and the shared FS look contended for the whole
modeled duration, under-reporting the bandwidth actually available — and
(b) feeds an EWMA calibration of the per-path bandwidth so subsequent
plans use observed rates.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.context import GB

GBPS = GB  # bytes/second per "gigabyte-per-second" unit


class FetchSource(enum.Enum):
    """Where a context acquisition comes from (see module docstring)."""

    PEER = "peer"
    POOL = "pool"
    DISK = "disk"
    FS = "fs"
    BUILD = "build"


@dataclass
class TransferPlan:
    source: str                 # "shared_fs", "pool", "disk" or donor id
    seconds: float
    nbytes: int
    p2p: bool
    fetch_source: FetchSource = FetchSource.FS
    # committed stripe lanes for a striped peer transfer (primary donor
    # first); single-donor plans carry a one-element tuple
    stripes: Tuple[str, ...] = ()
    # transport kind of a peer transfer: "memcpy" for in-process
    # thread-to-thread handoff, "socket" when any endpoint is a remote
    # process — calibration is namespaced per kind so wire lanes never
    # price from memcpy history (and vice versa)
    kind: str = "memcpy"

    def __post_init__(self):
        if self.p2p:
            self.fetch_source = FetchSource.PEER


@dataclass
class _Flow:
    done_at: float


class TransferPlanner:
    """Bandwidth-aware source selection with live flow tracking.

    shared-FS bandwidth is divided among concurrent FS pulls (the paper's
    filesystem bottleneck); each donor sustains ``p2p_bytes_per_s`` and
    serves ``donor_fanout`` concurrent receivers before saturating.

    Flow accounting: every planned transfer registers a flow whose modeled
    ``done_at`` gates later admission. Flows are pruned on EVERY read path
    (``plan``/``fs_load``/``donor_load``/``stats``) once ``done_at <= now``,
    and a live runtime should call :meth:`complete` the moment a transfer
    actually finishes — measured completions both free the donor/FS slot
    early and calibrate the planner's bandwidth estimates (EWMA over
    observed bytes/second).
    """

    def __init__(self, fs_bytes_per_s: float = 84 / 8 * GBPS,
                 p2p_bytes_per_s: float = 10 * GBPS,
                 nic_bytes_per_s: float = 1.25 * GBPS,
                 donor_fanout: int = 2,
                 h2d_bytes_per_s: float = 16 * GBPS,
                 disk_bytes_per_s: float = 2 * GBPS,
                 warmup_seconds: float = 16.0,
                 builder_bytes_per_s: float = 0.05 * GBPS,
                 d2h_bytes_per_s: float = 12 * GBPS,
                 chunk_bytes: int = 64 << 20):
        self.fs_bytes_per_s = fs_bytes_per_s      # aggregate Panasas
        self.p2p_bytes_per_s = p2p_bytes_per_s
        self.nic_bytes_per_s = nic_bytes_per_s    # per-node 10GbE cap
        self.donor_fanout = donor_fanout
        self.h2d_bytes_per_s = h2d_bytes_per_s    # host RAM -> HBM (PCIe)
        self.disk_bytes_per_s = disk_bytes_per_s  # local NVMe read
        # cold-path cost knobs for the scheduler's rung scoring: framework
        # warm-up on any from-scratch load (mirrors CostModel.
        # framework_warmup_s), and the modeled from-scratch construction
        # throughput — weight init + AOT compiles amortized over the
        # artifact payload, calibrated so a paper-size context builds in
        # minutes (the paper's 'minutes-long startup')
        self.warmup_seconds = warmup_seconds
        self.builder_bytes_per_s = builder_bytes_per_s
        self.d2h_bytes_per_s = d2h_bytes_per_s    # HBM -> host (donor export)
        # chunk granularity of streamed movement: the pipeline fill latency
        # (one chunk traversing every stage before steady-state overlap)
        self.chunk_bytes = chunk_bytes
        self._fs_flows: List[_Flow] = []
        self._donor_flows: Dict[str, List[_Flow]] = {}
        # measured-bandwidth calibration (EWMA bytes/s per path), fed by
        # complete(); None until the first live observation. Peer paths
        # are namespaced PER TRANSPORT KIND: an in-process memcpy handoff
        # measures orders of magnitude above a 10GbE socket lane, so a
        # shared "p2p" bucket would misprice the first wire transfer by
        # the same factor. A cold socket lane prices from the
        # conservative NIC default until its own observations arrive.
        self._measured: Dict[str, Optional[float]] = {
            "p2p:memcpy": None, "p2p:socket": None, "fs": None}
        # per-stage calibration for the pipelined rung scores, fed by
        # observe_stage() from live streamed movement
        self._measured_stage: Dict[str, Optional[float]] = {
            "d2h": None, "h2d": None, "disk": None}
        self._calibration_alpha = 0.5
        self.completed_flows = 0
        self.failed_flows = 0

    # ------------------------------------------------------------ internal --
    def _gc(self, now: float):
        """Prune flows whose modeled completion has passed. Called from
        every read path: a stale flow (done_at <= now) must never count
        against bandwidth shares or donor fanout."""
        self._fs_flows = [f for f in self._fs_flows if f.done_at > now]
        for d in list(self._donor_flows):
            self._donor_flows[d] = [f for f in self._donor_flows[d]
                                    if f.done_at > now]
            if not self._donor_flows[d]:
                del self._donor_flows[d]

    def _p2p_rate(self, kind: str = "memcpy") -> float:
        measured = self._measured.get(f"p2p:{kind}")
        if measured is not None:
            return measured
        if kind == "socket":
            return self.nic_bytes_per_s
        return min(self.p2p_bytes_per_s, self.nic_bytes_per_s)

    def _fs_rate(self, concurrent: int) -> float:
        measured = self._measured["fs"]
        if measured is not None:
            return measured / max(1, concurrent)
        return min(self.nic_bytes_per_s, self.fs_bytes_per_s / concurrent)

    def _fs_seconds(self, nbytes: int, now: float) -> float:
        concurrent = len(self._fs_flows) + 1
        return nbytes / self._fs_rate(concurrent)

    def _donor_seconds(self, donor: str, nbytes: int,
                       kind: str = "memcpy") -> Optional[float]:
        """Predicted seconds of one more transfer from ``donor``: the
        donor's uplink splits across its in-flight flows plus this one,
        then the per-flow rate is NIC-capped — a lightly loaded donor's
        receivers each still get their full NIC. A measured (EWMA) rate is
        already a per-flow rate observed under real contention, so it is
        used as-is rather than re-divided. Rates are looked up in the
        transport kind's own namespace — socket lanes never price from
        memcpy history. None when fanout-saturated."""
        flows = self._donor_flows.get(donor, [])
        if len(flows) >= self.donor_fanout:
            return None
        measured = self._measured.get(f"p2p:{kind}")
        if measured is not None:
            return nbytes / measured
        uplink = self.nic_bytes_per_s if kind == "socket" \
            else self.p2p_bytes_per_s
        share = uplink / (len(flows) + 1)
        return nbytes / min(share, self.nic_bytes_per_s)

    def _ranked_free_donors(self, donors: Set[str]) -> List[str]:
        """Free-slot donors, least-loaded first (best fanout share), id
        tie-break for determinism. Callers must have _gc'd already."""
        return sorted(
            (d for d in donors
             if len(self._donor_flows.get(d, [])) < self.donor_fanout),
            key=lambda d: (len(self._donor_flows.get(d, [])), d))

    def _stage_rate(self, stage: str,
                    override: Optional[float] = None) -> float:
        """Bytes/s for one pipeline stage: an explicit per-worker override
        wins (the scheduler passes each worker's own PCIe rate), else the
        live EWMA observation, else the modeled default."""
        if override is not None:
            return override
        measured = self._measured_stage.get(stage)
        if measured is not None:
            return measured
        return {"d2h": self.d2h_bytes_per_s,
                "h2d": self.h2d_bytes_per_s,
                "disk": self.disk_bytes_per_s}[stage]

    def _stripe_lanes(self, nbytes: int, donors: Set[str], width: int,
                      kinds: Optional[Dict[str, str]] = None
                      ) -> Optional[Tuple[List[str], float]]:
        """Up to ``width`` free donor lanes (least-loaded first) splitting
        ``nbytes`` into disjoint chunk ranges; seconds is the slowest
        lane's wire time. ``kinds`` maps donor id -> transport kind for
        this receiver (default memcpy). Callers must have _gc'd already."""
        ranked = self._ranked_free_donors(donors)
        if not ranked:
            return None
        lanes = ranked[:max(1, width)]
        per = -(-nbytes // len(lanes))
        sec = max(self._donor_seconds(d, per,
                                      kind=(kinds or {}).get(d, "memcpy"))
                  for d in lanes)
        return lanes, sec

    # -------------------------------------------------------------- public --
    def fs_load(self, now: float) -> int:
        """Concurrent shared-FS pulls still in flight at ``now``."""
        self._gc(now)
        return len(self._fs_flows)

    def donor_load(self, donor: str, now: float) -> int:
        """Concurrent receivers this donor is serving at ``now``."""
        self._gc(now)
        return len(self._donor_flows.get(donor, []))

    def plan(self, nbytes: int, donors: Set[str], now: float,
             allow_p2p: bool = True,
             fs_nbytes: Optional[int] = None) -> TransferPlan:
        """Pick the fastest currently-available source. ``fs_nbytes``
        overrides the FS payload (small-file metadata penalty on envs —
        P2P ships the packed template and is exempt)."""
        self._gc(now)
        best: Tuple[float, str, bool] = (
            self._fs_seconds(fs_nbytes if fs_nbytes is not None else nbytes,
                             now), "shared_fs", False)
        if allow_p2p:
            for d in sorted(donors):
                sec = self._donor_seconds(d, nbytes)
                if sec is not None and sec < best[0]:
                    best = (sec, d, True)
        seconds, source, p2p = best
        return self._register(TransferPlan(source=source, seconds=seconds,
                                           nbytes=nbytes, p2p=p2p), now)

    def peer_seconds(self, nbytes: int, donors: Set[str], now: float,
                     width: int = 1,
                     kinds: Optional[Dict[str, str]] = None
                     ) -> Optional[Tuple[str, float]]:
        """Side-effect-free prediction of the best admissible peer
        transfer: ``(primary_donor, seconds)``, or None when every donor
        is saturated. With ``width > 1`` the payload stripes across up to
        that many free donors (disjoint chunk ranges, slowest lane
        bounds), which is how multi-source striping shows up in the cost
        score. This is the PEER rung's score in the scheduler's cost
        chooser AND the selection the commit call (:meth:`peer_plan`)
        reuses — one code path, so the dry and commit decisions cannot
        drift."""
        self._gc(now)
        got = self._stripe_lanes(nbytes, donors, width, kinds=kinds)
        if got is None:
            return None
        lanes, sec = got
        return lanes[0], sec

    def peer_rate_seconds(self, nbytes: int, kind: str = "memcpy") -> float:
        """Predicted seconds of an UNCONSTRAINED peer transfer at the
        calibrated point-to-point rate (no fanout share): what a transfer
        would cost once a donor slot frees — the donor-wait cost bound."""
        return nbytes / self._p2p_rate(kind)

    def pipeline_seconds(self, stages: List[float], nbytes: int) -> float:
        """Latency of ``nbytes`` moving through serial ``stages`` (each a
        whole-payload seconds figure) CHUNK-PIPELINED: once the first
        chunk has traversed every stage, all stages run concurrently and
        the bottleneck stage sets the rate. ``fill = chunk/nbytes`` blends
        between the degenerate cases exactly — one chunk (fill=1) costs
        the old sum-of-stages, many chunks cost the bottleneck stage plus
        one chunk's worth of the others."""
        stages = [s for s in stages if s > 0]
        if not stages:
            return 0.0
        fill = min(1.0, self.chunk_bytes / max(1, nbytes))
        return fill * sum(stages) + (1.0 - fill) * max(stages)

    def d2h_seconds(self, nbytes: int) -> float:
        """Donor-side export stage: HBM -> host at the (calibrated)
        device_get rate."""
        return nbytes / self._stage_rate("d2h")

    def observe_stage(self, stage: str, nbytes: int, seconds: float):
        """Fold a live per-stage measurement (d2h/h2d/disk) into the
        pipeline calibration EWMA."""
        if stage not in self._measured_stage or seconds <= 0 or nbytes <= 0:
            return
        rate = nbytes / seconds
        prev = self._measured_stage[stage]
        a = self._calibration_alpha
        self._measured_stage[stage] = rate if prev is None \
            else a * rate + (1 - a) * prev

    def cold_load_seconds(self, transfer_bytes: int, host_bytes: int,
                          h2d_bytes_per_s: Optional[float] = None) -> float:
        """The load a fresh process pays once its artifact is node-local:
        framework warm-up, then local-disk read pipelined against the
        host->HBM promotion (chunked entries stream to device as they are
        read). Both the tail of the FS rung score (:meth:`cold_seconds`)
        and the post-transfer half of a committed FS fetch's ETA."""
        return self.warmup_seconds + self.pipeline_seconds(
            [transfer_bytes / self._stage_rate("disk"),
             host_bytes / self._stage_rate("h2d", h2d_bytes_per_s)],
            transfer_bytes)

    def cold_seconds(self, transfer_bytes: int, host_bytes: int, now: float,
                     h2d_bytes_per_s: Optional[float] = None) -> float:
        """Side-effect-free prediction of the FS rung end-to-end: framework
        warm-up plus the shared-FS fetch (at the CURRENT contention level)
        pipelined against the local-disk pass and the host->HBM
        promotion."""
        self._gc(now)
        return self.warmup_seconds + self.pipeline_seconds(
            [self._fs_seconds(transfer_bytes, now),
             transfer_bytes / self._stage_rate("disk"),
             host_bytes / self._stage_rate("h2d", h2d_bytes_per_s)],
            transfer_bytes)

    def build_seconds(self, transfer_bytes: int) -> float:
        """Modeled cost of the BUILD rung: framework warm-up plus from-
        scratch construction of the context payload (weight init + AOT
        compiles) at ``builder_bytes_per_s``. Deliberately slow per byte —
        building a paper-size context takes minutes, so BUILD only wins
        the cost race when there is (almost) nothing to transfer."""
        return self.warmup_seconds + transfer_bytes / self.builder_bytes_per_s

    def peer_plan(self, nbytes: int, donors: Set[str], now: float,
                  width: int = 1,
                  kinds: Optional[Dict[str, str]] = None
                  ) -> Optional[TransferPlan]:
        """Commit a P2P transfer from the best available donors (the same
        :meth:`peer_seconds` selection), or None when every donor is
        saturated (the scheduler then either waits for a slot or takes
        the cheapest remaining rung). With ``width > 1`` the commit
        stripes across up to that many free donors: one fanout flow per
        lane, ``plan.stripes`` naming the lanes (primary first). The
        plan's transport ``kind`` is socket when ANY lane crosses a
        process boundary, so measured completion calibrates the wire
        namespace, not memcpy."""
        self._gc(now)
        got = self._stripe_lanes(nbytes, donors, width, kinds=kinds)
        if got is None:
            return None
        lanes, sec = got
        kind = "socket" if any((kinds or {}).get(d) == "socket"
                               for d in lanes) else "memcpy"
        plan = TransferPlan(source=lanes[0], seconds=sec, nbytes=nbytes,
                            p2p=True, stripes=tuple(lanes), kind=kind)
        flows = []
        for d in lanes:
            flow = _Flow(done_at=now + sec)
            self._donor_flows.setdefault(d, []).append(flow)
            flows.append(flow)
        plan._flows = flows
        plan._flow = flows[0]
        return plan

    def fs_plan(self, nbytes: int, now: float,
                fs_nbytes: Optional[int] = None) -> TransferPlan:
        """Plan a shared-FS fetch at the current contention level."""
        self._gc(now)
        eff = fs_nbytes if fs_nbytes is not None else nbytes
        return self._register(
            TransferPlan(source="shared_fs",
                         seconds=self._fs_seconds(eff, now),
                         nbytes=nbytes, p2p=False), now)

    def pool_plan(self, nbytes: int, now: float,
                  from_disk: bool = False,
                  h2d_bytes_per_s: Optional[float] = None) -> TransferPlan:
        """Plan a snapshot promotion from the node pool (POOL/DISK rungs).
        Node-local PCIe/NVMe bandwidth — no shared-fabric flow to track."""
        plan = TransferPlan(
            source="disk" if from_disk else "pool",
            seconds=self.restore_seconds(nbytes, from_disk=from_disk,
                                         h2d_bytes_per_s=h2d_bytes_per_s),
            nbytes=nbytes, p2p=False,
            fetch_source=FetchSource.DISK if from_disk else FetchSource.POOL)
        return plan

    def _register(self, plan: TransferPlan, now: float) -> TransferPlan:
        flow = _Flow(done_at=now + plan.seconds)
        plan._flow = flow
        if plan.p2p:
            self._donor_flows.setdefault(plan.source, []).append(flow)
        else:
            self._fs_flows.append(flow)
        return plan

    def complete(self, plan: TransferPlan, now: float,
                 measured_seconds: Optional[float] = None,
                 failed: bool = False):
        """Report a planned transfer finished at ``now`` (live runtimes
        call this from the receiving worker). Frees the flow(s)
        immediately — the stale-flow fix: without it a fast real transfer
        would keep its donor/FS slot occupied for the whole MODELED
        duration — and, given ``measured_seconds``, folds the observed
        bytes/second into the planner's EWMA calibration. A ``failed``
        completion (dead donor/receiver, corrupt payload, degraded fetch)
        still frees every lane's flow — a dead transfer must not linger
        as a phantom in-flight flow inflating fanout shares — but counts
        under ``failed_flows`` and never touches the EWMA."""
        flows = getattr(plan, "_flows", None)
        if flows is None:
            flow = getattr(plan, "_flow", None)
            flows = [] if flow is None else [flow]
        for flow in flows:
            # pool_plan promotions are node-local and never registered a
            # flow: nothing to free, and they must not count as transfers
            flow.done_at = min(flow.done_at, now)
        if flows:
            self._gc(now)
            if failed:
                self.failed_flows += 1
            else:
                self.completed_flows += 1
        if failed:
            return
        if measured_seconds is not None and measured_seconds > 0 \
                and plan.fetch_source in (FetchSource.PEER, FetchSource.FS):
            path = f"p2p:{getattr(plan, 'kind', 'memcpy')}" \
                if plan.p2p else "fs"
            rate = plan.nbytes / measured_seconds
            prev = self._measured.get(path)
            a = self._calibration_alpha
            self._measured[path] = rate if prev is None \
                else a * rate + (1 - a) * prev

    def restore_seconds(self, nbytes: int, from_disk: bool = False,
                        h2d_bytes_per_s: Optional[float] = None) -> float:
        """Modeled promotion latency for a demoted context snapshot:
        host RAM -> HBM over PCIe, pipelined against the local-disk read
        when the snapshot was spilled (streamed restores ``device_put``
        entry *i* while entry *i+1* is read and verified). This is the
        paper's restore cost — compare against ``plan(...)`` + build for
        the cold path. Pass the worker's own PCIe bandwidth via
        ``h2d_bytes_per_s`` when a device profile is known (the simulator
        does); the planner default is a generic Gen4 x16 link."""
        stages = [nbytes / self._stage_rate("h2d", h2d_bytes_per_s)]
        if from_disk:
            stages.append(nbytes / self._stage_rate("disk"))
        return self.pipeline_seconds(stages, nbytes)

    def calibration(self) -> Dict:
        """Observed bytes/s per path (None until live feedback arrives).
        ``p2p`` remains an alias for the in-process memcpy namespace;
        socket-lane observations live under ``p2p:socket``."""
        out = dict(self._measured)
        out["p2p"] = self._measured["p2p:memcpy"]
        out.update(self._measured_stage)
        return out

    def stats(self, now: Optional[float] = None) -> Dict:
        if now is not None:
            self._gc(now)
        return {"fs_active": len(self._fs_flows),
                "donors_active": {k: len(v)
                                  for k, v in self._donor_flows.items()},
                "completed_flows": self.completed_flows,
                "failed_flows": self.failed_flows,
                "measured_bytes_per_s": self.calibration()}
