"""Data-parallel AWQ calibration of the port on the CPU, in one gloo world
of four ranks (``tests/torch_parallel_ranks.py``): ``AwqQuantizer(mesh=
build_mesh(data=4))`` and ``build_mesh(tensor=2, data=2)``, with the clip
search off and on, against JAX's ``AwqQuantizer(mesh=build_mesh(data=d))``
on its virtual CPU devices; the odd batch's fallback; ``_chunk_size``.

The model, calibration ids and bounds are JAX's own
(``tests/test_parallel.py:203-275``): scales within rtol 1e-4 / atol 1e-5,
at least 99.9% of the tree's elements within 1e-4 with the clip search
off and 99% with it on (its grid's exact ties may flip with the order of
the sums), logits within 5e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io.hf import init_random_params as jax_init
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.parallel.mesh import build_mesh as jax_mesh
from autoawq_tpu.quantize.quantizer import AwqQuantizer as JaxQuantizer
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.utils.tree import tensor_leaves

CFG = dict(model_type="llama", vocab_size=96, hidden_size=64,
           intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16,
           max_position_embeddings=32)


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(42)
    calib = rng.integers(0, 96, (8, 16))
    odd = rng.integers(0, 96, (7, 16))
    cfg = ModelConfig(**CFG)
    world = ranks.start_world(4, ["dp_calib"], {
        "dp_cfg": cfg, "dp_calib": calib, "dp_odd": odd})
    jcfg = JaxConfig(**CFG)
    params = jax_init(jcfg, seed=3, scale=0.08)
    qcfg = JaxAwqConfig(q_group_size=32)
    ref, qs = {}, {}
    fwd = jax.jit(lambda p, x: jm.forward(jcfg, p, x, method="jnp",
                                          dtype=np.float32))
    for d, clip in ((2, False), (4, False), (4, True)):
        mesh = jax_mesh(data=d, devices=jax.devices()[:d])
        q = qs[d] = JaxQuantizer(jcfg, qcfg, params, calib, progress=False,
                                 apply_clip=clip, mesh=mesh)
        tree = q.quantize()
        ref[(d, clip)] = {
            "tree": from_jax_params(cfg, jax.tree_util.tree_map(
                np.asarray, tree)),
            "scales": [np.asarray(s) for _, s in q.all_scales[0]],
            "logits": np.asarray(fwd(tree, jnp.asarray(calib[:2])))}
    ref["chunks"] = {}
    for d in (2, 4):
        for npar in (2, 4, 6):
            qs[d].n_parallel = npar
            ref["chunks"][(d, npar)] = qs[d]._chunk_size(8)
    return cfg, calib, ref, world.results()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}.{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}.{i}").items()}
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


def _close_share(a_tree, b_tree):
    a_flat, b_flat = _flat(a_tree), _flat(b_tree)
    assert a_flat.keys() == b_flat.keys()
    n_close = n_total = 0
    for key, a in a_flat.items():
        a, b = a.float().numpy(), b_flat[key].float().numpy()
        assert a.shape == b.shape, key
        n_close += np.isclose(a, b, rtol=1e-4, atol=1e-4).sum()
        n_total += a.size
    return n_close / n_total


def _results(res, key):
    out = res[0]["dp_calib"][key]
    for r in res[1:]:  # every rank chose the same
        for a, b in zip(tensor_leaves(r["dp_calib"][key]["tree"]),
                        tensor_leaves(out["tree"])):
            assert torch.equal(a, b)
    return out


@pytest.mark.parametrize("d", [2, 4])
def test_data_parallel_scales_and_tree_equal_jax(run, d):
    """Clip search off: every rank's tree is the same; the first layer's
    scales within rtol 1e-4 / atol 1e-5 of JAX's at the same data size,
    >= 99.9% of the tree's elements close, logits within 5e-3."""
    cfg, calib, ref, res = run
    got = _results(res, (d, False))
    want = ref[(d, False)]
    assert len(got["scales"]) == len(want["scales"])
    for a, b in zip(got["scales"], want["scales"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)
    assert _close_share(got["tree"], want["tree"]) >= 0.999
    logits = modules.forward(cfg, got["tree"], torch.from_numpy(calib[:2]),
                             method="plain", dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), want["logits"], rtol=5e-3,
                               atol=5e-3)


@pytest.mark.parametrize("d", [2, 4])
def test_data_parallel_with_clip_search_equals_jax(run, d):
    """Clip search on: >= 99% of the tree's elements close to JAX's
    data-4 run (grid ties may flip with the order of the sums)."""
    _, _, ref, res = run
    assert _close_share(_results(res, (d, True))["tree"],
                        ref[(4, True)]["tree"]) >= 0.99


def test_odd_batch_falls_back_to_one_process(run):
    """7 samples over a data axis of 4: a warning, and ``mesh`` is None."""
    assert all(r["dp_calib"]["odd_falls_back"] for r in run[3])


def test_chunk_size_composes_with_the_data_axis(run):
    """``n_parallel_calib_samples`` chunks of the whole batch stay
    multiples of the data axis, as JAX's ``_chunk_size`` keeps them."""
    _, _, ref, res = run
    assert res[0]["dp_calib"]["chunks"] == ref["chunks"]
    assert ref["chunks"][(4, 2)] is None and ref["chunks"][(2, 4)] == 4


def test_chunked_data_parallel_run_equals_unchunked(run):
    """Chunks of 4 samples (2 a rank) at data 2 give the unchunked tree."""
    _, _, _, res = run
    got = res[0]["dp_calib"]["chunked"]
    assert _close_share(got, res[0]["dp_calib"][(2, False)]["tree"]) == 1.0
