"""Worker node process: a LiveWorker's mailbox semantics over a socket.

``python -m repro_torch.cluster.node --connect HOST:PORT --worker-id w0``
starts one PCM worker in its OWN process: it dials the manager's listener,
sends a HELLO (identity + DeviceProfile), mirrors the runtime config from the
HELLO_ACK, and then runs a single-threaded frame loop that is byte-for-
byte the in-process worker's mailbox discipline — frames are consumed in
arrival order by one consumer, so preemption, retirement and stripe
ordering semantics carry over unchanged from :class:`LiveWorker`.

The node owns a real :class:`Library` and :class:`SnapshotPool`; the
manager holds only a mirror (counters + residency), updated by the status
dict riding on every reply frame. Context bytes cross the boundary through
``repro_torch.core.wire`` blobs (chunk-sha256-verified both ways) and — for
streamed PEER transfers — through the same ChunkPlan/StripeBuffer
machinery in-process transfers use: the node is a first-class stripe
donor AND receiver.

Heavy encodes (snapshot blobs, template blobs, chunk ``tobytes``) run on
the connection's writer thread via ``send_lazy``, never on the frame
loop, so a multi-GB export cannot stall task execution.

Port of ``repro.cluster.node``. A node serves on one device, ``--device``
(default ``cuda``, resolved by ``repro_torch.device.resolve``: without a
card it raises rather than serve on the CPU; tests pass ``--device
cpu``); engines that arrive as wire recipes are rebuilt there. The node
is a process of its own, started with ``subprocess.Popen`` and never
forked (a CUDA context does not survive a fork), so it holds a CUDA
context of its own. ``--aot-cache DIR`` points the kernel build
directory at ``DIR`` (``kernels.build.set_build_dir``): a node joining
after another process built the libraries there loads them and runs no
``nvcc``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import queue
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from repro_torch.core import wire as pcm_wire

_PICKLE = pickle.HIGHEST_PROTOCOL


def _status_error(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {exc}"


class WorkerHost:
    """The node-process half of one RemoteWorker."""

    def __init__(self, worker_id: str, spill_dir: Optional[str] = None,
                 device: str = "cuda"):
        from repro_torch.core.library import Library
        from repro_torch.core.store import SnapshotPool
        from repro_torch.device import resolve
        self.worker_id = worker_id
        # where engines that arrive as wire recipes are rebuilt
        self.device = resolve(device)
        self.pool = SnapshotPool(spill_dir=spill_dir)
        self.library = Library(worker_id, snapshots=self.pool,
                               streamed=True)
        self.conn = None                    # set by run()
        self.inbox: "queue.SimpleQueue" = queue.SimpleQueue()
        # config mirrored from hello_ack
        self.mode = None
        self.chunk_bytes = 64 << 20
        self.export_chunk_budget = 4
        # receiver-side stripes: sid -> {buf, recipe, pending, done}
        self._rstripes: Dict[int, Dict[str, Any]] = {}
        # donor-side stripes concluded by the manager (stop exporting)
        self._cancelled: set = set()
        # status-delta cursors
        self._sent_records = 0
        self._sent_sources = 0

    # -------------------------------------------------------------- status --
    def status(self) -> Dict:
        """Library counters (absolute) + new records/sources/stage timings
        since the last report — the mirror's whole data feed."""
        lib = self.library
        records = [bool(r.cold)
                   for r in lib.records[self._sent_records:]]
        self._sent_records = len(lib.records)
        sources = [s.name for s in lib.fetch_sources[self._sent_sources:]]
        self._sent_sources = len(lib.fetch_sources)
        stage_obs, lib.stage_observations = lib.stage_observations, []
        return {
            "counters": {
                "build_seconds_total": lib.build_seconds_total,
                "restore_seconds_total": lib.restore_seconds_total,
                "aot_seconds_total": lib.aot_seconds_total,
                "builder_calls": lib.builder_calls,
                "restores": lib.restores,
                "demotions": lib.demotions,
                "peer_installs": lib.peer_installs,
                "peer_exports": lib.peer_exports,
                "peer_install_seconds": lib.peer_install_seconds,
            },
            "records": records,
            "sources": sources,
            "resident": sorted(lib.resident_keys),
            "stage_obs": [[s, int(n), float(t)] for s, n, t in stage_obs],
        }

    # ---------------------------------------------------------- transport --
    def enqueue(self, _conn, kind: str, meta: Dict, payload: bytes):
        self.inbox.put((kind, meta, payload))

    def lost(self, _conn, reason: str):
        self.inbox.put(("__lost__", {"reason": reason}, b""))

    # --------------------------------------------------------------- loop --
    def run_loop(self):
        while True:
            kind, meta, payload = self.inbox.get()
            if kind == "__lost__":
                return
            if kind in ("stop", "retire"):
                try:
                    self._shutdown(retire=(kind == "retire"))
                except BaseException:
                    traceback.print_exc(file=sys.stderr)
                self.conn.send("bye", {"status": self.status()})
                # let the writer drain the farewell (incl. lazily encoded
                # retirement snapshots) before the process exits
                time.sleep(0.2)
                return
            try:
                handler = getattr(self, f"_h_{kind}", None)
                if handler is None:
                    print(f"node {self.worker_id}: unknown frame "
                          f"{kind!r}", file=sys.stderr)
                    continue
                handler(meta, payload)
            except BaseException:
                traceback.print_exc(file=sys.stderr)

    def _shutdown(self, retire: bool):
        """Retirement = the manager reclaimed this device: demote every
        resident context and ship the snapshots back so they land in the
        MANAGER's node pool (the promotion source for rejoining workers).
        Then drain the inbox like a dying LiveWorker: fail stripe lanes
        and pending installs so nothing upstream waits forever."""
        if retire:
            self.library.demote_all(force=True)
            for key in list(self.pool.keys()):
                snap = self.pool.take(key)
                if snap is None:
                    continue
                if snap.spilled:
                    snap.unspill(self.pool.spill_store())
                self.conn.send_lazy(
                    lambda snap=snap, key=key: (
                        "demoted_ctx", {"key": key},
                        _encode_snapshot(snap, self.chunk_bytes)))
        while True:
            try:
                kind, meta, _payload = self.inbox.get_nowait()
            except queue.Empty:
                break
            if kind == "donate_chunks" or kind == "__donate__":
                spec = meta["spec"]
                self.conn.send("stripe_lane_lost", {
                    "sid": meta["sid"],
                    "lane": spec.get("via_lane", spec["lane"]),
                    "corrupt": False})
            elif kind == "donate":
                self.conn.send("snapshot", {"token": meta["token"],
                                            "ok": False,
                                            "status": self.status()})
            elif kind in ("fetch", "install"):
                self.conn.send("done", {"token": meta["token"],
                                        "ok": False, "op": "fetch",
                                        "status": self.status()})
            elif kind == "install_stripe":
                self.conn.send("stripe_done", {"sid": meta["sid"],
                                               "ok": False,
                                               "status": self.status()})
            elif kind in ("warm",):
                self.conn.send("ack", {"token": meta["token"],
                                       "ok": False,
                                       "error": "worker retired",
                                       "status": self.status()})
            elif kind == "demote":
                self.conn.send("demoted", {"token": meta["token"],
                                           "has": False,
                                           "status": self.status()})

    # ------------------------------------------------------------ handlers --
    def _h_hello_ack(self, meta: Dict, payload: bytes):
        from repro_torch.core.store import ContextMode
        self.mode = ContextMode(meta["mode"])
        self.library.streamed = bool(meta.get("streamed", True))
        self.chunk_bytes = int(meta.get("chunk_bytes", 64 << 20))
        self.export_chunk_budget = int(meta.get("export_chunk_budget", 4))
        for key in meta.get("pinned") or []:
            self.library.pin(key)

    def _h_task(self, meta: Dict, payload: bytes):
        from repro_torch.core.store import ContextMode
        task_id = meta["task_id"]
        value: Any = None
        error: Optional[BaseException] = None
        named: Dict = {}
        try:
            (fn, args, kwargs), named = pickle.loads(payload)
            value = self.library.invoke(fn, args, kwargs,
                                        recipes=named or None,
                                        task_id=task_id)
        except BaseException as exc:
            error = exc
        if self.mode == ContextMode.AGNOSTIC:
            self.library.evict_all()
        elif self.mode == ContextMode.PARTIAL:
            for recipe in named.values():
                self.library.evict(recipe.key())
        ok = error is None
        body = value if ok else error
        try:
            blob = pickle.dumps(body, _PICKLE)
        except BaseException as exc:
            ok = False
            blob = pickle.dumps(RuntimeError(
                f"task {task_id} result not picklable: {exc}"), _PICKLE)
        self.conn.send("result", {"task_id": task_id, "ok": ok,
                                  "status": self.status()}, blob)

    def _h_fetch(self, meta: Dict, payload: bytes):
        """The manager's pool had no copy: run the node's own ladder
        (FS artifacts / builder)."""
        token = meta["token"]
        ok = True
        key = meta.get("key", "")
        try:
            recipe = pickle.loads(payload)
            key = recipe.key()
            self.library.ensure(recipe)
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            ok = False
        src = self.library.fetch_sources[-1].name \
            if ok and self.library.fetch_sources else None
        self.conn.send("done", {"token": token, "ok": ok, "op": "fetch",
                                "key": key, "source": src,
                                "status": self.status()})

    def _h_install(self, meta: Dict, payload: bytes):
        """A snapshot arrived as a wire blob (pool promotion or PEER
        donation), or a degraded install (no blob) that falls down this
        node's own ladder."""
        from repro_torch.core.context import restore_context
        from repro_torch.core.transfer import FetchSource
        token = meta["token"]
        op = meta.get("op", "install")
        ok = True
        degraded = False
        measured = None
        source = meta.get("source")
        try:
            if meta.get("wire") and payload:
                snap = pcm_wire.decode_snapshot(payload,
                                                device=self.device)
                ctx = restore_context(snap, self.worker_id)
                if source in ("POOL", "DISK"):
                    # promotion bookkeeping mirrors Library.ensure's pool
                    # path (the pool itself lives manager-side)
                    self.library.install(ctx)
                    self.library.restores += 1
                    self.library.restore_seconds_total += \
                        ctx.restore_seconds
                    self.library._record_source(FetchSource[source])
                else:
                    self.library.adopt(ctx)
                    source = "PEER"
                    measured = snap.demote_seconds + ctx.restore_seconds
            else:
                recipe = pickle.loads(payload)
                self.library.ensure(recipe)
                degraded = meta.get("degraded_from") is not None
                source = self.library.fetch_sources[-1].name \
                    if self.library.fetch_sources else None
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            ok = False
            measured = None
        self.conn.send("done", {
            "token": token, "ok": ok, "op": op, "key": meta.get("key"),
            "source": source, "measured": measured, "degraded": degraded,
            "degraded_from": meta.get("degraded_from"),
            "status": self.status()})

    def _h_donate(self, meta: Dict, payload: bytes):
        """Monolithic donor export: snapshot the warm context and ship the
        wire blob (encode runs on the writer thread)."""
        from repro_torch.core.context import export_context
        token = meta["token"]
        key = meta["key"]
        snap = None
        if self.library.has(key):
            try:
                snap = export_context(self.library.context(key))
                self.library.peer_exports += 1
            except BaseException:
                traceback.print_exc(file=sys.stderr)
        if snap is None:
            self.conn.send("snapshot", {"token": token, "ok": False,
                                        "status": self.status()})
            return
        status = self.status()
        self.conn.send_lazy(
            lambda: ("snapshot", {"token": token, "ok": True,
                                  "status": status},
                     _encode_snapshot(snap, self.chunk_bytes)))

    def _h_donate_chunks(self, meta: Dict, payload: bytes):
        recipe = pickle.loads(payload)
        self._donate_turn(meta["sid"], recipe, meta["spec"])

    def _h___donate__(self, meta: Dict, payload: bytes):
        # continuation posted to our own inbox tail (recipe already live)
        self._donate_turn(meta["sid"], meta["recipe"], meta["spec"])

    def _donate_turn(self, sid: int, recipe, spec: Dict):
        """One budgeted export turn of a donor stripe lane — the node-side
        twin of ``LiveWorker._handle_donate_chunks``. Chunks frame out as
        DONOR_CHUNK (payload = raw bytes) and the manager's tracker or the
        local StripeBuffer verifies them against the shipped sha."""
        from repro_torch.core.context import (stripe_export_state,
                                              stripe_export_template)
        from repro_torch.core.streaming import (ChunkPlan, assign_lanes,
                                                chunk_digest, host_chunk)
        key = recipe.key()
        lane = spec["lane"]
        via = spec.get("via_lane", lane)
        if sid in self._cancelled:
            return
        if not self.library.has(key):
            self.conn.send("stripe_lane_lost",
                           {"sid": sid, "lane": via, "corrupt": False})
            return
        t0 = time.monotonic()
        sent = 0
        try:
            ctx = self.library.context(key)
            device = stripe_export_state(ctx)
            plan = ChunkPlan(device, chunk_bytes=self.chunk_bytes)
            if spec.get("with_template"):
                clone, host_halves, host_nbytes = \
                    stripe_export_template(ctx)
                self.library.peer_exports += 1
                nbytes = host_nbytes + plan.total_bytes
                bs, aots = ctx.build_seconds, ctx.aot_seconds
                cb = self.chunk_bytes
                self.conn.send_lazy(
                    lambda: ("template", {"sid": sid},
                             pcm_wire.encode_template(
                                 recipe, clone, host_halves, device,
                                 nbytes, bs, aots, chunk_bytes=cb)))
                spec = dict(spec, with_template=False)
            if spec.get("ref_ids") is not None:
                wanted = {tuple(t) for t in spec["ref_ids"]}
                refs = [r for r in plan.refs if r.id in wanted]
            else:
                refs = assign_lanes(plan.refs, spec["n_donor"],
                                    spec["n_pool"])[lane]
            cursor = spec.get("cursor", 0)
            depth = self.inbox.qsize()
            budget = None if depth <= 0 \
                else max(1, self.export_chunk_budget // (1 + depth))
            stop = len(refs) if budget is None \
                else min(len(refs), cursor + budget)
            flat = ChunkPlan.flat_map(device)
            while cursor < stop:
                if sid in self._cancelled:
                    return
                ref = refs[cursor]
                # the host copy of the device slice is the only point this
                # turn touches the device
                piece = host_chunk(plan.extract(flat, ref))
                sent += piece.numel() * piece.element_size()
                self.conn.send_lazy(
                    lambda piece=piece, ref=ref: (
                        "donor_chunk",
                        {"sid": sid,
                         "ref": [ref.key, ref.index, ref.count, ref.axis,
                                 ref.start, ref.stop],
                         "sha": chunk_digest(piece), "lane": via,
                         **pcm_wire.chunk_meta(piece)},
                        pcm_wire.chunk_bytes_of(piece)))
                cursor += 1
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            self.conn.send("stripe_lane_lost",
                           {"sid": sid, "lane": via, "corrupt": False})
            return
        finally:
            elapsed = time.monotonic() - t0
            self.conn.send("lane_drained", {"sid": sid, "lane": via,
                                            "seconds": elapsed,
                                            "sent": sent})
        if cursor < len(refs):
            self.inbox.put(("__donate__",
                            {"sid": sid, "recipe": recipe,
                             "spec": dict(spec, cursor=cursor)}, b""))

    def _h_stripe_cancel(self, meta: Dict, payload: bytes):
        self._cancelled.add(meta["sid"])

    # ------------------------------------------------- stripe receiving ----
    def _rstripe(self, sid: int) -> Dict[str, Any]:
        from repro_torch.core.streaming import StripeBuffer
        entry = self._rstripes.get(sid)
        if entry is None:
            entry = {"buf": StripeBuffer(), "recipe": None,
                     "pending": False, "done": False}
            self._rstripes[sid] = entry
        return entry

    def _h_stripe_template(self, meta: Dict, payload: bytes):
        from repro_torch.core.streaming import ChunkPlan
        sid = meta["sid"]
        entry = self._rstripe(sid)
        if entry["done"]:
            return
        dec = pcm_wire.decode_template(payload, device=self.device)
        plan = ChunkPlan(dec["spec_tree"], chunk_bytes=dec["chunk_bytes"])
        entry["recipe"] = dec["recipe"]
        entry["buf"].set_template(plan, dec["clone"], dec["host_halves"],
                                  dec["nbytes"], dec["build_seconds"],
                                  dec["aot_seconds"])
        if entry["pending"] and entry["buf"].complete():
            self._install_stripe(sid)

    def _h_stripe_chunk(self, meta: Dict, payload: bytes):
        from repro_torch.core.streaming import ChunkCorruptionError, ChunkRef
        sid = meta["sid"]
        entry = self._rstripe(sid)
        if entry["done"]:
            return
        ref = ChunkRef(meta["ref"][0], *map(int, meta["ref"][1:]))
        arr = pcm_wire.chunk_from_frame(meta, payload)
        try:
            entry["buf"].deliver(ref, arr, meta["sha"],
                                 lane=meta["lane"])
        except ChunkCorruptionError:
            traceback.print_exc(file=sys.stderr)
            self.conn.send("stripe_lane_lost", {
                "sid": sid, "lane": meta["lane"], "corrupt": True,
                "delivered": [list(d)
                              for d in entry["buf"].delivered_ids()]})
            return
        if entry["pending"] and entry["buf"].complete():
            self._install_stripe(sid)

    def _h_install_stripe(self, meta: Dict, payload: bytes):
        sid = meta["sid"]
        entry = self._rstripe(sid)
        if entry["done"]:
            return
        if not entry["buf"].complete():
            # a lane-loss reconcile raced the install trigger: install the
            # moment the re-forwarded chunks complete the buffer
            entry["pending"] = True
            return
        self._install_stripe(sid)

    def _install_stripe(self, sid: int):
        from repro_torch.core.context import ContextSnapshot, restore_context
        entry = self._rstripes.get(sid)
        if entry is None or entry["done"]:
            return
        entry["done"] = True
        buf = entry["buf"]
        ok = True
        measured = None
        key = None
        try:
            host_state = buf.assemble()
            snap = ContextSnapshot(
                recipe=entry["recipe"], value=buf.clone,
                host_state=host_state, nbytes=buf.nbytes,
                build_seconds=buf.build_seconds,
                aot_seconds=buf.aot_seconds,
                demote_seconds=buf.export_seconds)
            key = snap.key
            ctx = restore_context(snap, self.worker_id)
            self.library.adopt(ctx)
            measured = snap.demote_seconds + ctx.restore_seconds
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            ok = False
            measured = None
        self._rstripes.pop(sid, None)
        self.conn.send("stripe_done", {"sid": sid, "ok": ok, "key": key,
                                       "measured": measured,
                                       "status": self.status()})

    # ---------------------------------------------------------- lifecycle --
    def _h_warm(self, meta: Dict, payload: bytes):
        token = meta["token"]
        try:
            self.library.ensure(pickle.loads(payload))
            self.conn.send("ack", {"token": token, "ok": True,
                                   "status": self.status()})
        except BaseException as exc:
            traceback.print_exc(file=sys.stderr)
            self.conn.send("ack", {"token": token, "ok": False,
                                   "error": _status_error(exc),
                                   "status": self.status()})

    def _h_demote(self, meta: Dict, payload: bytes):
        """Demote DEVICE -> (manager's) HOST_RAM pool: snapshot locally,
        pull it back out of the node-local pool and ship the blob — the
        manager-side pool is the authoritative context parking lot."""
        token = meta["token"]
        key = meta["key"]
        snap = self.library.demote(key)    # None when absent or pinned
        if snap is not None:
            self.pool.take(key)
            if snap.spilled:
                snap.unspill(self.pool.spill_store())
        if snap is None:
            self.conn.send("demoted", {"token": token, "has": False,
                                       "status": self.status()})
            return
        status = self.status()
        self.conn.send_lazy(
            lambda: ("demoted", {"token": token, "has": True,
                                 "status": status},
                     _encode_snapshot(snap, self.chunk_bytes)))

    def _h_pin(self, meta: Dict, payload: bytes):
        self.library.pin(meta["key"])

    def _h_unpin(self, meta: Dict, payload: bytes):
        self.library.unpin(meta["key"])


def _encode_snapshot(snap, chunk_bytes: int) -> bytes:
    return pcm_wire.encode_snapshot(snap, chunk_bytes=chunk_bytes)


# ----------------------------------------------------------- entrypoint ----
def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="PCM worker node: joins a PCMManager over the socket "
                    "transport")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--profile", default=None,
                    help="DeviceProfile name from repro_torch.cluster.devices")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    ap.add_argument("--path", action="append", default=[],
                    help="extra sys.path entries (module-level builders "
                         "for recipes crossing the wire)")
    ap.add_argument("--aot-cache", default=None,
                    help="kernel build directory shared with other "
                         "processes (libraries built there load as cache "
                         "hits instead of nvcc runs)")
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument("--heartbeat", type=float, default=1.0)
    args = ap.parse_args(argv)

    for p in args.path:
        if p and p not in sys.path:
            sys.path.insert(0, p)
    if args.aot_cache:
        from repro_torch.kernels import build
        build.set_build_dir(args.aot_cache)

    from repro_torch.core.transport import Connection
    profile = None
    if args.profile:
        from repro_torch.cluster.devices import PROFILES
        profile = PROFILES.get(args.profile)
    # resolved before dialing: a node without its device never joins
    host = WorkerHost(args.worker_id, spill_dir=args.spill_dir,
                      device=args.device)

    host_str, _, port_str = args.connect.rpartition(":")
    sock = socket.create_connection((host_str, int(port_str)), timeout=10)
    sock.settimeout(None)
    conn = Connection(sock, "manager", on_frame=host.enqueue,
                      on_lost=host.lost, heartbeat=args.heartbeat)
    host.conn = conn
    # HELLO is queued BEFORE the writer starts so it is provably the
    # first frame out — the manager's accept thread expects it and would
    # reject a heartbeat arriving first
    conn.send("hello", {"worker_id": args.worker_id, "pid": os.getpid()},
              pickle.dumps(profile, _PICKLE))
    conn.start()
    try:
        host.run_loop()
    finally:
        conn.close()
    return 0


def spawn_node_process(address, worker_id: str,
                       profile: Optional[str] = None,
                       aot_cache: Optional[str] = None,
                       spill_dir: Optional[str] = None,
                       extra_path: tuple = (),
                       heartbeat: float = 1.0,
                       device: str = "cuda",
                       env: Optional[Dict[str, str]] = None
                       ) -> "subprocess.Popen":
    """Launch one worker node as a subprocess (``subprocess.Popen``, a
    fresh interpreter: never a fork) pointed at a manager's ``listen()``
    address. PYTHONPATH is extended with this package's source root plus
    ``extra_path`` (where module-level recipe builders live), so the child
    can unpickle everything the manager sends."""
    import repro_torch
    src_root = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    cmd = [sys.executable, "-m", "repro_torch.cluster.node",
           "--connect", f"{address[0]}:{address[1]}",
           "--worker-id", worker_id,
           "--heartbeat", str(heartbeat), "--device", str(device)]
    if profile:
        cmd += ["--profile", profile]
    if aot_cache:
        cmd += ["--aot-cache", aot_cache]
    if spill_dir:
        cmd += ["--spill-dir", spill_dir]
    for p in extra_path:
        cmd += ["--path", str(p)]
    child_env = dict(os.environ if env is None else env)
    parts = [src_root] + [str(p) for p in extra_path]
    if child_env.get("PYTHONPATH"):
        parts.append(child_env["PYTHONPATH"])
    child_env["PYTHONPATH"] = os.pathsep.join(parts)
    return subprocess.Popen(cmd, env=child_env)


if __name__ == "__main__":
    sys.exit(run())
