"""The port's examples (``repro_torch.examples``) on the CPU, held to the
reference's examples (``examples/``, loaded by path where a function is
compared) at the reduced sizes:

- the Prompt-for-Fact sweep gives the reference's correct counts per
  template on the same bridged weights;
- ``opportunistic_serving --backend sim`` prints the reference's lines;
- the live elastic sweep, its trace compressed by
  ``ElasticRunner(time_scale=...)``, completes through preemptions and
  joins with every claim answered once and the verdicts of a bare engine:
  the regression for a demote that emptied the model every worker's
  engine shares;
- quickstart's sections give the counters the reference prints;
- ``train_smollm`` resumes from its checkpoint;
- every ``main`` refuses to run without a card unless given
  ``--device cpu``."""

import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.data import fever  # noqa: E402
from repro_torch.data.tokenizer import (LABEL_TOKENS,  # noqa: E402
                                        HashTokenizer)
from repro_torch.examples import (fact_verification,  # noqa: E402
                                  opportunistic_serving, quickstart,
                                  train_smollm)
from repro_torch.serving import InferenceEngine  # noqa: E402
from repro_torch.weights import from_jax_params, to_jax_params  # noqa

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = (fact_verification, opportunistic_serving, quickstart,
            train_smollm)


def reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------ fact verification --
def test_fact_sweep_matches_reference_counts(tmp_path):
    """A briefly trained verifier's weights, as the reference's params
    tree, bridged into the port by ``from_jax_params``: the port's sweep
    (two workers sharing one model) counts the reference engine's
    correct claims per template (the reference's ``verify_batch`` body,
    same engine knobs, same batches)."""
    cfg, state = fact_verification.train_verifier(60, str(tmp_path),
                                                  device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, to_jax_params(state, cfg))
    claims, batch = 48, 16
    got = fact_verification.sweep(cfg, from_jax_params(tree, cfg, "cpu"),
                                  claims, batch, device="cpu")
    jmodel = jax_build(jax_config("smollm2-1.7b"))
    jeng = JaxEngine(jmodel, tree, **fact_verification.ENGINE_KW)
    tok = HashTokenizer(cfg.vocab_size)
    want = []
    for template in fever.PROMPT_CANDIDATES:
        n = 0
        for b in range(0, claims, batch):
            cl = fever.claim_batch(range(b, min(b + batch, claims)))
            outs = jeng.generate(
                [tok.encode(fever.render_prompt(c, template)) for c in cl],
                max_new_tokens=1)
            n += sum(int(o[0] == LABEL_TOKENS[c.label])
                     for o, c in zip(outs, cl))
        want.append(n)
    assert got["correct"] == want
    assert 0 < sum(want) < claims * len(want), "vacuous: all or nothing"
    assert got["stats"]["builder_calls"] >= 1


# ------------------------------------------------- opportunistic serving --
@pytest.mark.parametrize("trace", ["rq3", "rq4"])
def test_simulated_cluster_prints_the_reference_lines(trace, capsys):
    reference_example("opportunistic_serving").simulated_cluster(trace)
    want = capsys.readouterr().out
    opportunistic_serving.main(["--backend", "sim", "--trace", trace,
                                "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert want.count("\n") == (3 if trace == "rq3" else 2)


def test_simulated_cluster_as_a_module(capsys):
    reference_example("opportunistic_serving").simulated_cluster("rq3")
    want = capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.opportunistic_serving",
         "--backend", "sim", "--trace", "rq3", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == want


@pytest.fixture(scope="module")
def verifier():
    return opportunistic_serving.build_verifier(device="cpu")


def bare_tokens(model, n_tasks):
    """Each task's first tokens from one engine with the example's knobs."""
    eng = InferenceEngine(model, device="cpu",
                          **opportunistic_serving.ENGINE_KW)
    tok = HashTokenizer(model.cfg.vocab_size)
    out = []
    for idx in opportunistic_serving.task_claims(n_tasks):
        cl = fever.claim_batch(idx)
        gen = eng.generate([tok.encode(fever.render_prompt(c)) for c in cl],
                           max_new_tokens=1)
        out.append([o[0] for o in gen])
    return out


@pytest.mark.parametrize("trace,n_tasks", [("rq3", 200), ("rq4", 100)])
def test_live_elastic_sweep_through_churn(verifier, trace, n_tasks):
    """The live example with its trace ten times faster than the wall
    clock: rq3 preempts workers whose engines share the one model with
    the survivors, rq4 joins workers that bootstrap from warm donors.
    Every task completes once, requeued ones included, with a bare
    engine's first tokens (the seeded model's verdicts are all 0, so the
    tokens are what is compared); each builder call built no kernel."""
    want = bare_tokens(verifier, n_tasks)
    assert len({t for ts in want for t in ts}) > 1, "vacuous: one token"
    got = opportunistic_serving.live_elastic(trace, n_tasks, device="cpu",
                                             model=verifier, time_scale=10)
    assert got["tokens"] == want
    assert got["verdicts"] == [
        opportunistic_serving.verdicts(t, idx) for t, idx in
        zip(want, opportunistic_serving.task_claims(n_tasks))]
    assert got["claims"] == 8 * n_tasks and got["completed"] == n_tasks
    assert got["failed"] == 0
    if trace == "rq3":
        assert got["preemptions"] >= 1 and got["joins"] == 4
    else:
        assert got["joins"] >= 3 and got["preemptions"] == 0
    builds = got["builds"]
    assert got["builder_calls"] == len(builds) >= 1
    assert len({b["thread"] for b in builds}) == len(builds)
    assert not any(b["compiles"] for b in builds)
    assert got["invocations"] >= n_tasks


# ------------------------------------------------------------- quickstart --
def test_quickstart_sections(capsys):
    """Every section of quickstart's main on the CPU, the node process
    with ``device="cpu"``: the counters the reference prints, the paged
    pool's tokens equal the slot cache's, shared-prefix tokens equal cold
    ones, and the simulator's modeled run equal to the reference's."""
    out = quickstart.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["live"]["tiers"] == {"live000": "DEVICE", "live001": "DEVICE"}
    assert out["live"]["builder_calls"] == 2
    assert out["restore"]["requeued_completed"] == 2
    assert out["restore"]["snapshot_tier"] == "HOST_RAM"
    assert out["restore"]["restores"] == 1
    assert out["restore"]["builds_during_restore"] == 0
    assert out["peer"]["source"] == "peer"
    assert out["peer"]["builder_calls"] == 2
    assert len(out["front_door"]["streamed"]) == 8
    assert out["front_door"]["sheds"] == ["rate_limit"]
    assert out["multi_host"]["builder_calls"] == 1
    assert out["multi_host"]["restores"] == 1
    assert out["multi_host"]["sources"] == ["FS", "POOL"]

    paged, shared = out["paged"], out["prefix"]
    model = paged["engine"].model
    kw = quickstart.paged_kw(model.cfg)
    slot_kw = {k: v for k, v in kw.items()
               if k not in ("paged", "page_size", "num_pages")}
    assert paged["completed"] == 8 and paged["live_bytes"] == 0
    assert paged["tokens"] == InferenceEngine(
        model, device="cpu", **slot_kw).generate(paged["prompts"],
                                                 max_new_tokens=8)
    cold = InferenceEngine(model, device="cpu", prefix_sharing=False, **kw)
    assert shared["tokens"] == cold.generate(shared["prompts"],
                                             max_new_tokens=8)
    assert shared["prefix_hits"] >= 1 and shared["cow_copies"] >= 1

    from repro.core import ContextMode as JaxMode
    from repro.core import PCMClient as JaxClient
    from repro.core import SimulatorBackend as JaxSim
    ref = reference_example("quickstart")
    sim = JaxClient(backend=JaxSim(n_workers=8, profile="a10",
                                   mode=JaxMode.FULL))
    results, _ = ref.run_workload(sim, [f"claim {i}" for i in range(800)],
                                  batch_size=50)
    st = sim.stats()
    assert out["simulator"] == dict(
        inferences=sum(r.n_items for r in results), simulated_s=st["now"],
        warm_starts=st["warm_starts"], cold_starts=st["cold_starts"],
        p2p_transfers=st["p2p_transfers"])
    assert printed.index("== live backend") < printed.index(
        "== simulator backend")


# ----------------------------------------------------------- train_smollm --
def test_train_smollm_resumes_from_its_checkpoint(tmp_path, monkeypatch):
    """A run cut at step 30 by a failing data pipeline resumes from the
    step-25 checkpoint and ends with the losses of an uninterrupted run."""
    args = ["--device", "cpu", "--steps", "50", "--batch-size", "4",
            "--seq-len", "16", "--d-model", "64"]
    whole = train_smollm.main(args + ["--checkpoint-dir",
                                      str(tmp_path / "a")])
    cut_dir = ["--checkpoint-dir", str(tmp_path / "b")]
    real = train_smollm.batches

    def preempted(pcfg, start):
        for i, b in enumerate(real(pcfg, start)):
            if start + i == 30:
                raise KeyboardInterrupt("preempted")
            yield b

    monkeypatch.setattr(train_smollm, "batches", preempted)
    with pytest.raises(KeyboardInterrupt):
        train_smollm.main(args + cut_dir)
    monkeypatch.setattr(train_smollm, "batches", real)
    resumed = train_smollm.main(args + cut_dir)
    assert [r.step for r in resumed["records"]] == list(range(26, 51))
    np.testing.assert_array_equal(
        [r.loss for r in resumed["records"]],
        [r.loss for r in whole["records"][25:]])
    again = train_smollm.main(args + cut_dir)
    assert again["records"] == []


# -------------------------------------------------------------- no card ----
@pytest.mark.parametrize("example", EXAMPLES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_refuses_without_a_card(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
    assert importlib.import_module(example.__name__) is example
