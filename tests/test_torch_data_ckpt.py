"""The port's data pipeline and checkpoint store against the JAX
package's: the same batches byte for byte, and checkpoints that each
package restores from the other, bit for bit."""

import json
import os
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import TokenDataset as JaxTokenDataset  # noqa: E402
from repro.models.transformer import LM as JaxLM  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402
from repro_torch.tree import flatten_with_keys  # noqa: E402


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "whisper_base", "llama32_vision_90b"])
@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_batches_equal_jax_byte_for_byte(arch, seed):
    jds = JaxTokenDataset(jax_get_config(arch).smoke(), seq_len=24, global_batch=4, seed=seed)
    ds = TokenDataset(get_config(arch).smoke(), seq_len=24, global_batch=4, seed=seed)
    for step in (0, 1, 7, 1000):
        for shard, n_shards in ((0, 1), (0, 2), (1, 2), (3, 4)):
            want = jds.get_batch(step, shard, n_shards)
            got = ds.get_batch(step, shard, n_shards)
            assert set(got) == set(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                assert got[key].tobytes() == want[key].tobytes(), (key, step, shard)


def test_data_determinism_and_restore():
    """tests/test_substrate.py::test_data_determinism_and_sharding, in the port."""
    ds = TokenDataset(get_config("qwen2_0_5b").smoke(), seq_len=8, global_batch=4, seed=3)
    a = ds.get_batch(5)
    np.testing.assert_array_equal(a["tokens"], ds.get_batch(5)["tokens"])
    assert not np.array_equal(a["tokens"], ds.get_batch(6)["tokens"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == 0).all()
    ds2, step = TokenDataset.restore(ds.cfg, 8, 4, ds.state(5))
    np.testing.assert_array_equal(ds2.get_batch(step)["tokens"], a["tokens"])
    with pytest.raises(ValueError, match="shards"):
        ds.get_batch(0, 0, 3)


# -- checkpoints ------------------------------------------------------------------


def _states(seed=0):
    """The same training state for both packages: smoke-LM parameters in
    bf16 and AdamW moments in f32 after one update, as numpy."""
    cfg = replace(jax_get_config("qwen2_0_5b").smoke(), param_dtype="bfloat16")
    jparams = JaxLM(cfg).init(jax.random.PRNGKey(seed))
    jopt = JaxAdamW()
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jparams)
    jparams, jstate, _ = jopt.update(grads, jopt.init(jparams), jparams)
    jtree = {"params": jparams, "opt": jstate}
    host = jax.tree.map(np.asarray, {"params": jparams, "m": jstate.m, "v": jstate.v})
    ptree = {"params": params_from_numpy(host["params"], "cpu"),
             "opt": OptState(step=torch.tensor(int(jstate.step), dtype=torch.int32),
                             m=params_from_numpy(host["m"], "cpu"),
                             v=params_from_numpy(host["v"], "cpu"))}
    return jtree, ptree


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (str(x.dtype).removeprefix("torch."), tuple(x.shape),
                x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_keys_equal_jax_store_keys():
    jtree, ptree = _states()
    keys = [k for k, _ in flatten_with_keys(ptree)]
    assert keys == list(_jax_flat(jtree))        # JAX's leaf order, names included
    assert {"opt/step", "opt/m/blocks/wq", "opt/v/emb", "params/emb"} <= set(keys)


def test_files_equal_jax_store_files(tmp_path):
    """The same state saved by both stores gives the same manifest and the
    same .npy bytes, leaf by leaf."""
    jtree, ptree = _states()
    JaxStore(str(tmp_path / "jax")).save(3, jtree, extra={"seed": 0, "step": 3})
    CheckpointStore(str(tmp_path / "port")).save(3, ptree, extra={"seed": 0, "step": 3})
    dj, dp = tmp_path / "jax" / "step_00000003", tmp_path / "port" / "step_00000003"
    mj = json.loads((dj / "manifest.json").read_text())
    mp = json.loads((dp / "manifest.json").read_text())
    assert mj == mp
    assert {v["dtype"] for v in mp["leaves"].values()} == {"bfloat16", "float32", "int32"}
    for info in mj["leaves"].values():
        assert (dj / info["file"]).read_bytes() == (dp / info["file"]).read_bytes()


def test_jax_checkpoint_restores_in_port_bit_for_bit(tmp_path):
    jtree, ptree = _states(1)
    JaxStore(str(tmp_path)).save(5, jtree)
    back = CheckpointStore(str(tmp_path)).restore(5, _states(2)[1])
    assert type(back["opt"]).__name__ == "OptState"
    want = _jax_flat(jtree)
    for key, leaf in flatten_with_keys(back):
        assert _bits(leaf) == _bits(want[key]), key


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    jtree, ptree = _states(3)
    CheckpointStore(str(tmp_path)).save(9, ptree, extra={"note": "port"})
    back = JaxStore(str(tmp_path)).restore(9, _states(4)[0])
    assert JaxStore(str(tmp_path)).extra(9) == {"note": "port"}
    want = dict(flatten_with_keys(ptree))
    for key, leaf in _jax_flat(back).items():
        assert _bits(leaf) == _bits(want[key]), key


def test_save_commits_via_rename_and_restores(tmp_path):
    store = CheckpointStore(str(tmp_path))
    state = {"w": torch.randn(4, 8), "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    path = store.save(3, state, extra={"loss": 1.25})
    assert os.path.basename(path) == "step_00000003"
    assert not os.path.exists(path + ".tmp")
    assert store.steps() == [3] and store.latest_step() == 3
    back = store.restore(3, state)
    assert torch.equal(back["w"], state["w"]) and back["opt"]["step"].shape == ()
    assert store.extra(3) == {"loss": 1.25}


def test_crash_mid_save_leaves_latest_restorable(tmp_path):
    store = CheckpointStore(str(tmp_path))
    state = {"w": torch.arange(6.0)}
    store.save(1, state)
    tmp = tmp_path / "step_00000002.tmp"        # a writer that died before commit
    tmp.mkdir()
    np.save(tmp / "leaf_00000.npy", np.zeros(3))
    (tmp_path / "step_00000005").mkdir()         # renamed but no manifest
    assert store.steps() == [1] and store.latest_step() == 1
    assert torch.equal(store.restore(1, state)["w"], state["w"])
    store.save(2, {"w": torch.ones(6)})          # recovers from the stale tmp
    assert store.steps() == [1, 2]


def test_gc_keeps_last_k_and_async(tmp_path):
    store = CheckpointStore(str(tmp_path / "sync"), keep=2)
    for s in range(5):
        store.save(s, {"x": torch.full((2,), float(s))})
    assert store.steps() == [3, 4]
    assert store.restore(4, {"x": torch.zeros(2)})["x"].tolist() == [4.0, 4.0]
    astore = CheckpointStore(str(tmp_path / "async"), keep=2)
    for s in (1, 2, 3, 4):
        astore.save_async(s, {"p": torch.full((2,), float(s), dtype=torch.bfloat16)})
    astore.wait()
    assert astore.steps() == [3, 4]
    back = astore.restore(4, {"p": torch.zeros(2, dtype=torch.bfloat16)})
    assert back["p"].dtype == torch.bfloat16 and back["p"].tolist() == [4.0, 4.0]


def test_restore_onto_shardings_is_not_ported(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(0, {"w": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        store.restore(0, {"w": torch.zeros(2)}, shardings={"w": None})
