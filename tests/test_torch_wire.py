"""The port's wire layer against the reference's: socket frames byte for
byte across ``repro.core.transport`` and ``repro_torch.core.transport``,
packed wire state (``_pack_state``) with the same JSON table and array
payload in both packages, snapshot and template blobs of the reduced
smollm2-1.7b engine that decode and then decode tokens bit-identically,
chunk-granular corruption and malformed blobs, the engine's fingerprint,
and the planner's per-transport-kind calibration (the reference's
``TestTransportKindCalibration``)."""

import pickle
import socket
import struct

import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import transport as jtransport  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro_torch.checkpoint.io import ChunkCorruptionError  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import (TransferPlanner, export_context,  # noqa
                              make_recipe, materialize, restore_context,
                              snapshot_context)
from repro_torch.core import transport, wire  # noqa: E402
from repro_torch.core.context import (stripe_export_state,  # noqa: E402
                                      stripe_export_template)
from repro_torch.core.streaming import ChunkPlan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402
from repro_torch.serving.engine import engine_from_wire  # noqa: E402

SLOT = dict(slots=2, cache_len=64, prefill_buckets=(16,), megastep=4)
PROMPTS = [[5, 9, 14, 200, 7], [11, 3, 60], [300, 301, 302, 303, 8, 9]]


# ------------------------------------------------------------- frames ----
FRAMES = [
    ("hb", {}, b""),
    ("task", {"task_id": "t00003", "token": 7}, b"payload"),
    ("donor_chunk", {"sid": 2, "ref": ["c0/params/w", 1, 4, 0, 8, 16],
                     "sha": "ab" * 32, "lane": 1, "dtype": "bfloat16",
                     "shape": [8, 3]}, bytes(range(256)) * 3),
    ("hello_ack", {"mode": "full", "pinned": ["k1", "k2"],
                   "chunk_bytes": 1 << 26}, b""),
]


def _frame_bytes(write, kind, meta, payload):
    a, b = socket.socketpair()
    try:
        write(a, kind, dict(meta), payload)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            got = b.recv(1 << 16)
            if not got:
                return out
            out += got
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("frame", FRAMES, ids=[f[0] for f in FRAMES])
def test_frames_byte_identical_across_packages(frame):
    kind, meta, payload = frame
    mine = _frame_bytes(transport.write_frame, kind, meta, payload)
    theirs = _frame_bytes(jtransport.write_frame, kind, meta, payload)
    assert mine == theirs
    # each package's reader reads the other's frame
    for write, read in ((transport.write_frame, jtransport.read_frame),
                        (jtransport.write_frame, transport.read_frame)):
        a, b = socket.socketpair()
        try:
            write(a, kind, dict(meta), payload)
            assert read(b) == (kind, meta, payload)
        finally:
            a.close()
            b.close()


def test_garbage_length_prefix_fails_fast():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<IQ", 1 << 30, 0))
        with pytest.raises(transport.TransportError):
            transport.read_frame(b)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------- packed state --
def _state_tree(seed=0):
    """A seeded nested tree: f32, i32 and bf16 leaves, one f32 leaf larger
    than the 4 KiB chunk size, one scalar-shaped leaf, non-array leaves.
    Returns the reference's tree (bf16 as ml_dtypes) and the port's (bf16
    as a tensor)."""
    rng = np.random.RandomState(seed)
    bf = rng.standard_normal((7, 5)).astype(ml_dtypes.bfloat16)
    common = {
        "params": {"w": rng.standard_normal((40, 64)).astype(np.float32),
                   "b": rng.standard_normal((64,)).astype(np.float32)},
        "lengths": rng.randint(0, 64, size=(4,)).astype(np.int32),
        "step": np.array(3, np.int32),
        "meta": {"page": 8, "tag": None, "name": "c0"},
    }
    ref = dict(common, half=bf)
    port = dict(common, half=torch.from_numpy(
        bf.view(np.int16).copy()).view(torch.bfloat16))
    return ref, port


def test_pack_state_matches_reference():
    """The same leaves give the same JSON table (manifest with per-entry
    and per-chunk sha256, leaf keys ``L{idx:05d}``) and a byte-equal
    array payload. The pickled sections differ by design: the reference
    pickles a jax treedef, the port its own tree structure."""
    ref_tree, port_tree = _state_tree()
    j_table, j_side, j_payload = jwire._pack_state(ref_tree, 4096)
    t_table, t_side, t_payload = wire._pack_state(port_tree, 4096)
    assert t_table == j_table
    assert t_payload == j_payload
    assert any(v["count"] > 1 for v in t_table["manifest"]["chunks"]
               .values())
    assert t_table["manifest"]["dtypes"]["L00000"] == "bfloat16"
    assert t_side != j_side
    back = wire._unpack_state(t_table, t_side, t_payload)
    assert back["meta"] == port_tree["meta"]
    assert isinstance(back["params"]["w"], np.ndarray)
    assert back["params"]["w"].dtype == np.float32
    assert np.array_equal(back["params"]["w"], port_tree["params"]["w"])
    assert back["half"].dtype == torch.bfloat16
    assert torch.equal(back["half"], port_tree["half"])


def test_chunk_frames_round_trip_bf16():
    x = torch.randn(9, 4, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    meta = wire.chunk_meta(x)
    assert meta == {"dtype": "bfloat16", "shape": [9, 4]}
    back = wire.chunk_from_frame(meta, wire.chunk_bytes_of(x))
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)


# ------------------------------------------------------------- snapshots --
def build_engine_ctx():
    cfg = get_reduced_config("smollm2-1.7b")
    return {"engine": InferenceEngine(build_model(cfg, device="cpu"),
                                      device="cpu", **SLOT),
            "note": "fact verification"}


@pytest.fixture(scope="module")
def donor():
    ctx = materialize(make_recipe("wire-smol", build_engine_ctx))
    eng = ctx.value["engine"]
    want = eng.generate(PROMPTS, max_new_tokens=6)
    return ctx, want


@pytest.mark.parametrize("how", ["export", "demote"])
def test_snapshot_round_trip_decodes_bit_identically(how):
    """A template export (PEER) or a demotion of a used engine crosses the
    wire and restores into a shell rebuilt from the engine's wire recipe:
    greedy tokens equal the donor's, and nothing is built."""
    ctx = materialize(make_recipe("wire-smol", build_engine_ctx))
    eng = ctx.value["engine"]
    want = eng.generate(PROMPTS, max_new_tokens=6)
    snap = export_context(ctx) if how == "export" else snapshot_context(ctx)
    blob = wire.encode_snapshot(snap, chunk_bytes=32 << 10)
    assert bytes(blob[:4]) == b"PCMW"
    out = wire.decode_snapshot(blob, device="cpu")
    assert out.recipe.key() == snap.recipe.key()
    assert out.nbytes == snap.nbytes
    got = restore_context(out, "receiver").value
    assert got["note"] == "fact verification"
    recv = got["engine"]
    assert recv is not eng and recv._aot_shared
    assert recv.aot_fingerprint == eng.aot_fingerprint
    assert recv.generate(PROMPTS, max_new_tokens=6) == want
    assert recv.stats.compiles == 0


def test_flipped_payload_byte_raises_chunk_corruption(donor):
    ctx, _ = donor
    blob = bytearray(wire.encode_snapshot(export_context(ctx),
                                          chunk_bytes=32 << 10))
    blob[-8] ^= 0xFF                       # a byte of the last weights chunk
    with pytest.raises(ChunkCorruptionError, match="wire"):
        wire.decode_snapshot(bytes(blob))


def test_bad_magic_version_and_truncation_raise_wire_error(donor):
    ctx, _ = donor
    snap = export_context(ctx)
    blob = wire.encode_snapshot(snap)
    with pytest.raises(wire.WireError, match="magic"):
        wire.decode_snapshot(b"NOPE" + blob[4:])
    with pytest.raises(wire.WireError, match="version"):
        wire.decode_snapshot(blob[:4] + struct.pack("<H", 2) + blob[6:])
    with pytest.raises(wire.WireError, match="truncated"):
        wire.decode_snapshot(blob[:len(blob) // 2])
    with pytest.raises(wire.WireError, match="kind"):
        wire.decode_template(blob)
    snap.spilled = True
    with pytest.raises(wire.WireError, match="spilled"):
        wire.encode_snapshot(snap)


def test_template_specs_plan_like_the_donor(donor):
    """The manager's cheap peek and the receiver's full decode rebuild the
    donor's chunk plan from LeafSpecs alone, chunk for chunk."""
    ctx, _ = donor
    device = stripe_export_state(ctx)
    clone, halves, host_nbytes = stripe_export_template(ctx)
    plan = ChunkPlan(device, chunk_bytes=16 << 10)
    blob = wire.encode_template(ctx.recipe, clone, halves, device,
                                nbytes=host_nbytes + plan.total_bytes,
                                build_seconds=1.5, aot_seconds=0.5,
                                chunk_bytes=16 << 10)
    specs, meta = wire.decode_template_specs(blob)
    full = wire.decode_template(blob, device="cpu")
    assert meta["chunk_bytes"] == full["chunk_bytes"] == 16 << 10
    assert meta["nbytes"] == full["nbytes"] == host_nbytes + plan.total_bytes
    for tree in (specs, full["spec_tree"]):
        again = ChunkPlan(tree, chunk_bytes=meta["chunk_bytes"])
        assert again.refs == plan.refs and len(plan.refs) > 1
        assert again.total_bytes == plan.total_bytes
    assert full["recipe"].key() == ctx.recipe.key()
    assert full["clone"]["engine"].offloaded
    assert pickle.loads(pickle.dumps(specs)) == specs


# ----------------------------------------------------------- fingerprint --
def test_fingerprint_equal_knobs_equal_one_bucket_differs():
    cfg = get_reduced_config("smollm2-1.7b")

    def fp(**kw):
        return InferenceEngine(build_model(cfg, device="cpu"), device="cpu",
                               **dict(SLOT, **kw)).aot_fingerprint

    base = fp()
    assert fp() == base
    assert fp(prefill_buckets=(8,)) != base
    assert fp(megastep=1) != base
    eng = InferenceEngine(build_model(cfg, device="cpu"), device="cpu",
                          **SLOT)
    rec = eng.wire_recipe()
    assert rec["fingerprint"] == base
    shell = engine_from_wire(rec, device="cpu")
    assert shell.offloaded and shell._aot_shared
    assert shell.aot_fingerprint == base


# ------------------------------------ per-transport-kind calibration ----
def test_cold_socket_lane_prices_from_nic_defaults():
    """A blazing in-process memcpy history must NOT make the first wire
    transfer look free: the socket namespace prices from the NIC default
    until its own observations arrive."""
    pl = TransferPlanner()
    nbytes = 1 << 30
    plan = pl.peer_plan(nbytes, {"a"}, now=0.0)
    assert plan is not None and plan.kind == "memcpy"
    pl.complete(plan, now=0.0, measured_seconds=1e-3)
    assert pl.calibration()["p2p:memcpy"] == pytest.approx(nbytes / 1e-3)
    assert pl.calibration()["p2p:socket"] is None
    assert pl.peer_rate_seconds(nbytes, kind="socket") == \
        pytest.approx(nbytes / pl.nic_bytes_per_s)
    got = pl.peer_seconds(nbytes, {"b"}, now=100.0, kinds={"b": "socket"})
    assert got is not None
    assert got[1] == pytest.approx(nbytes / pl.nic_bytes_per_s)


def test_socket_observations_stay_in_their_namespace():
    pl = TransferPlanner()
    nbytes = 64 << 20
    plan = pl.peer_plan(nbytes, {"remote"}, now=0.0,
                        kinds={"remote": "socket"})
    assert plan is not None and plan.kind == "socket"
    pl.complete(plan, now=0.0, measured_seconds=2.0)
    cal = pl.calibration()
    assert cal["p2p:socket"] == pytest.approx(nbytes / 2.0)
    assert cal["p2p:memcpy"] is None
    assert pl.peer_rate_seconds(nbytes, kind="socket") == pytest.approx(2.0)
    assert pl.peer_rate_seconds(nbytes, kind="memcpy") == \
        pytest.approx(nbytes / min(pl.p2p_bytes_per_s, pl.nic_bytes_per_s))


def test_mixed_stripe_calibrates_as_socket():
    """One remote lane makes the whole stripe a wire transfer for
    calibration: the slowest lane is the one that matters."""
    pl = TransferPlanner()
    plan = pl.peer_plan(64 << 20, {"local", "remote"}, now=0.0, width=2,
                        kinds={"remote": "socket"})
    assert plan is not None
    assert set(plan.stripes) == {"local", "remote"}
    assert plan.kind == "socket"
