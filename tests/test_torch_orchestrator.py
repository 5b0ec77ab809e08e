"""The port's ``train.orchestrator`` against the JAX package's, on the
CPU: Myrmics-scheduled training of the qwen2-0.5B smoke config (f32, the
JAX init carried across as numpy) step by step against
``repro.train.orchestrator.run_myrmics_training``, the port's sim and
threads backends bit for bit, and the virtual schedules of
``run_training_schedule`` and ``locality_sweep`` exactly."""

import dataclasses
import gc
import weakref
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.train.orchestrator as jax_orch  # noqa: E402
import repro_torch.train.orchestrator as orch  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import LM as JaxLM  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.tree import flatten_with_keys, leaves  # noqa: E402

# losses absolute: 10x tests/test_torch_train.py's one-step f32 LOSS_TOL,
# for the drift of three AdamW steps; parameters: max error over the
# leaf's max magnitude, that file's f32 REL_TOL
LOSS_TOL, REL_TOL = 1e-4, 1e-4
RUN = dict(seq_len=16, global_batch=4, steps=3, n_shards=2, seed=0)
# Adam's first step is lr·g/(|g| + eps), the sign of g for the default
# eps, which flips between two correct implementations wherever g is near
# 0; eps = 1e-2 makes it a smooth function of g (tests/test_torch_train.py)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=RUN["steps"], eps=1e-2)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _recording(module, monkeypatch):
    """Replace ``module``'s ``Myrmics`` with a subclass that keeps each
    instance, so the test can read the final object store."""
    seen = []

    class Recording(module.Myrmics):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(module, "Myrmics", Recording)
    return seen


def _jax_init(cfg, seed):
    return jax.tree.map(np.asarray, JaxLM(cfg).init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX orchestrator on sim: (losses, final parameters as numpy)."""
    cfg = replace(jax_get_config("qwen2_0_5b").smoke(), **F32)
    with pytest.MonkeyPatch.context() as mp:
        seen = _recording(jax_orch, mp)
        rep, run_rep = jax_orch.run_myrmics_training(cfg, opt=JaxAdamW(**OPT), backend="sim",
                                                     **RUN)
    assert run_rep.tasks_done == run_rep.tasks_spawned
    params = seen[0].labelled_storage()["params"]
    return rep.losses, {k: np.asarray(v) for k, v in _flat_jax(params).items()}


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_run(monkeypatch, backend):
    """The port's orchestrator from the JAX init: (losses, final
    parameters by key, run report)."""
    jcfg = replace(jax_get_config("qwen2_0_5b").smoke(), **F32)
    monkeypatch.setattr(LM, "init", lambda self, seed=0: params_from_numpy(
        _jax_init(jcfg, seed), self.device))
    seen = _recording(orch, monkeypatch)
    cfg = replace(get_config("qwen2_0_5b").smoke(), **F32)
    rep, run_rep = orch.run_myrmics_training(cfg, opt=AdamW(**OPT), backend=backend,
                                             device="cpu", **RUN)
    return rep.losses, dict(flatten_with_keys(seen[0].labelled_storage()["params"])), run_rep


def test_sim_matches_the_jax_orchestrator(jax_run, monkeypatch):
    want_losses, want_params = jax_run
    losses, params, run_rep = _port_run(monkeypatch, "sim")
    assert run_rep.tasks_done == run_rep.tasks_spawned == 1 + RUN["steps"] * (RUN["n_shards"] + 1)
    assert len(losses) == RUN["steps"]
    assert max(abs(a - b) for a, b in zip(losses, want_losses, strict=True)) < LOSS_TOL, \
        (losses, want_losses)
    assert set(params) == set(want_params)
    for key, want in want_params.items():
        got = params[key].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, key
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
        assert rel < REL_TOL, (key, rel)


def test_threads_is_bit_identical_to_sim(monkeypatch):
    sim_losses, sim_params, sim_rep = _port_run(monkeypatch, "sim")
    thr_losses, thr_params, thr_rep = _port_run(monkeypatch, "threads")
    assert thr_rep.backend == "threads"
    assert thr_rep.tasks_done == thr_rep.tasks_spawned == sim_rep.tasks_done
    assert thr_losses == sim_losses
    assert all(torch.equal(thr_params[k], sim_params[k]) for k in sim_params)


def test_the_initial_state_is_freed_once_replaced(monkeypatch):
    """On threads the run keeps one parameter and optimizer state alive:
    the initial ones are gone once the first update has replaced them (at
    full width they are ~5 GB of the card's memory)."""
    refs = []

    def recorded(init):
        def wrapper(self, *args, **kwargs):
            state = init(self, *args, **kwargs)
            refs.extend(weakref.ref(x) for x in leaves(state))
            return state
        return wrapper

    monkeypatch.setattr(LM, "init", recorded(LM.init))
    monkeypatch.setattr(AdamW, "init", recorded(AdamW.init))
    alive = []

    def on_step(step, loss):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))

    orch.run_myrmics_training(get_config("qwen2_0_5b").smoke(), seq_len=16, global_batch=4,
                              steps=3, n_shards=2, backend="threads", device="cpu",
                              on_step=on_step)
    assert len(refs) > 0 and alive == [0, 0, 0]


def test_run_training_schedule_matches_jax():
    kw = dict(n_domains=8, sched_levels=(1, 2), steps=2, slow_domains={3: 4.0})
    got = orch.run_training_schedule(orch.OrchestratorConfig(**kw))
    want = jax_orch.run_training_schedule(jax_orch.OrchestratorConfig(**kw))
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]


def test_locality_sweep_matches_jax():
    """tests/test_substrate.py's Fig. 11 sweep, on the port's runtime."""
    kw = dict(policy_points=(100, 0), n_domains=8, sched_levels=(1, 2), steps=2)
    res = orch.locality_sweep(**kw)
    assert res == jax_orch.locality_sweep(**kw)
    assert res[100]["dma_per_step"] <= res[0]["dma_per_step"]
    assert res[0]["cycles_per_step"] < res[100]["cycles_per_step"]


def test_global_batch_must_split_into_shards():
    with pytest.raises(ValueError, match="divisible"):
        orch.run_myrmics_training(get_config("qwen2_0_5b").smoke(), global_batch=3,
                                  n_shards=2, device="cpu")


def test_procs_names_the_roadmap_slice():
    cfg = get_config("qwen2_0_5b").smoke()
    with pytest.raises(NotImplementedError, match="ROADMAP.md .*Slice 5"):
        orch.run_myrmics_training(cfg, seq_len=16, global_batch=2, steps=1,
                                  backend="procs", device="cpu")
