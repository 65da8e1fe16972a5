"""LLaVA and LLaVA-NeXT in the port (``autoawq_tpu_torch/models/vision``)
against the JAX package's ``models/vision`` on the same seeded checkpoint
(a transformers model drawn from a seed, as numpy) and the same numpy
pixels and ids. Tolerances: splice positions and state-dict keys exactly;
f32 tower features within 1e-5 and f32 logits within 1e-4 of their scale
(summation order only); the quantized LM's logits (K1 / K2's twin on the
CPU against JAX's jnp path, the same int4 tree) within 1e-4 of the scale."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.models import vision as jv
from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
from autoawq_tpu.quantize import quantizer as jquantizer
from autoawq_tpu.utils.tree import iter_linears as jax_iter_linears
from autoawq_tpu.utils.tree import set_by_path as jax_set_by_path
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models import vision as pv
from autoawq_tpu_torch.models.config import ModelConfig
from torch_vl_util import (LLAVA_IMG, rel_err, tiny_llava, tiny_llava_next,
                           torch_sd)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llava():
    raw, sd = tiny_llava()
    jcfg = JaxModelConfig.from_hf_dict(raw["text_config"])
    cfg = ModelConfig.from_hf_dict(raw["text_config"])
    return (raw, sd, jcfg, cfg, jv.llava_params_from_state_dict(jcfg, sd),
            pv.llava_params_from_state_dict(cfg, torch_sd(sd)))


def _inputs(seed=0, n_img=1, s=14):
    rng = np.random.default_rng(seed)
    ids = rng.integers(6, 128, (1, s))
    for i in range(n_img):  # 4 placeholders an image
        ids[0, 2 + 5 * i:6 + 5 * i] = LLAVA_IMG
    pixels = rng.standard_normal((n_img, 3, 16, 16)).astype(np.float32)
    return ids, pixels


@pytest.mark.parametrize("layer", [0, 1, 2, -1, -2, -3])
def test_clip_tower_at_every_feature_layer(llava, layer):
    raw, _, _, _, jp, pp = llava
    _, pixels = _inputs(n_img=2)
    want = np.asarray(jv.clip_vision_features(
        raw["vision_config"], jp["vision_tower"], jnp.asarray(pixels),
        layer))
    got = pv.clip_vision_features(raw["vision_config"], pp["vision_tower"],
                                  torch.from_numpy(pixels), layer)
    assert got.shape == want.shape == (2, 5, 32)
    assert rel_err(got, want) < 1e-5


def test_projector_and_raster_splice(llava):
    raw, _, jcfg, cfg, jp, pp = llava
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 4, 32)).astype(np.float32)
    want = np.asarray(jv.llava_project(jp["projector"], jnp.asarray(feats)))
    got = pv.llava_project(pp["projector"], torch.from_numpy(feats))
    assert rel_err(got, want) < 1e-5
    # the splice: the k-th placeholder of the batch takes the k-th row
    ids = rng.integers(6, 128, (2, 9))
    ids[0, [1, 2, 7]] = LLAVA_IMG
    ids[1, [0, 4, 5, 8, 3]] = LLAVA_IMG
    emb = rng.standard_normal((2, 9, 64)).astype(np.float32)
    rows = rng.standard_normal((8, 64)).astype(np.float32)
    want = np.asarray(jv.merge_image_features(
        jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(rows), LLAVA_IMG))
    got = pv.merge_image_features(torch.from_numpy(emb),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(rows), LLAVA_IMG)
    np.testing.assert_array_equal(got.numpy(), want)
    flat = got.reshape(-1, 64).numpy()
    np.testing.assert_array_equal(
        flat[(ids == LLAVA_IMG).reshape(-1)], rows[:8])


def test_input_embeds_and_f32_logits_equal_jax(llava):
    raw, _, jcfg, cfg, jp, pp = llava
    ids, pixels = _inputs(n_img=2, s=16)
    kw = dict(image_token_index=LLAVA_IMG)
    want_e = np.asarray(jv.llava_input_embeds(
        jcfg, raw["vision_config"], jp, jnp.asarray(ids),
        jnp.asarray(pixels), **kw))
    got_e = pv.llava_input_embeds(cfg, raw["vision_config"], pp,
                                  torch.from_numpy(ids),
                                  torch.from_numpy(pixels), **kw)
    assert rel_err(got_e, want_e) < 1e-5
    want = np.asarray(jv.llava_forward(
        jcfg, raw["vision_config"], jp, jnp.asarray(ids),
        jnp.asarray(pixels), method="jnp", **kw))
    got = pv.llava_forward(cfg, raw["vision_config"], pp,
                           torch.from_numpy(ids), torch.from_numpy(pixels),
                           method="auto", **kw)
    assert got.dtype == torch.float32 and got.shape == (1, 16, 128)
    assert rel_err(got, want) < 1e-4
    # no pixels: the text path
    want = np.asarray(jv.llava_forward(jcfg, raw["vision_config"], jp,
                                       jnp.asarray(ids), None, method="jnp",
                                       **kw))
    got = pv.llava_forward(cfg, raw["vision_config"], pp,
                           torch.from_numpy(ids), None, **kw)
    assert rel_err(got, want) < 1e-4


def _jax_rtn_lm(jcfg, jp):
    """JAX's round-to-nearest int4 of the language model (g32)."""
    lm = jp["language_model"]
    qcfg = JaxAwqConfig(q_group_size=32)
    for lp in lm["layers"]:
        for path, p in list(jax_iter_linears(lp)):
            jax_set_by_path(lp, path, jquantizer.quantize_linear_params(
                {k: jnp.asarray(v) for k, v in p.items()}, qcfg))
    import jax

    return {**jp, "language_model": jax.tree_util.tree_map(np.asarray, lm)}


def test_quantized_logits_through_the_kernels_route(llava):
    """The int4 language model: JAX's tree carried across by
    ``from_jax_params`` (the multimodal branch), the port's
    ``method="auto"`` (K1 / K2; their twins on the CPU) against JAX's."""
    raw, sd, jcfg, cfg, _, _ = llava
    jq = _jax_rtn_lm(jcfg, jv.llava_params_from_state_dict(jcfg, sd))
    pq = from_jax_params(cfg, jq)
    assert set(pq) == {"language_model", "vision_tower", "projector"}
    assert "qweight" in pq["language_model"]["layers"][0]["self_attn"][
        "q_proj"]
    ids, pixels = _inputs(seed=1, s=12)
    want = np.asarray(jv.llava_forward(
        jcfg, raw["vision_config"], jq, jnp.asarray(ids),
        jnp.asarray(pixels), image_token_index=LLAVA_IMG, method="jnp"))
    got = pv.llava_forward(cfg, raw["vision_config"], pq,
                           torch.from_numpy(ids), torch.from_numpy(pixels),
                           image_token_index=LLAVA_IMG, method="auto")
    assert rel_err(got, want) < 1e-4


def _legacy(sd):
    """transformers' legacy LLaVA layout of a current-layout state dict."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.language_model."):
            k = "language_model.model." + k[len("model.language_model."):]
        elif k.startswith("lm_head."):
            k = "language_model." + k
        elif k.startswith("model."):
            k = k[len("model."):]
        out[k] = v
    return out


@pytest.mark.parametrize("layout", ["current", "legacy"])
def test_state_dict_round_trip_in_both_layouts(llava, layout):
    """Both layouts load into the same tree; the quantized tree writes the
    keys and values JAX's writer writes."""
    raw, sd, jcfg, cfg, _, pp = llava
    src = sd if layout == "current" else _legacy(sd)
    got = pv.llava_params_from_state_dict(cfg, torch_sd(src))
    ids, pixels = _inputs(seed=2)
    a = pv.llava_forward(cfg, raw["vision_config"], got,
                         torch.from_numpy(ids), torch.from_numpy(pixels),
                         image_token_index=LLAVA_IMG)
    b = pv.llava_forward(cfg, raw["vision_config"], pp,
                         torch.from_numpy(ids), torch.from_numpy(pixels),
                         image_token_index=LLAVA_IMG)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    jq = _jax_rtn_lm(jcfg, jv.llava_params_from_state_dict(jcfg, src))
    want = jv.llava_state_dict_from_params(jcfg, jq)
    mine = pv.llava_state_dict_from_params(cfg, from_jax_params(cfg, jq))
    assert set(mine) == set(want)
    for k in want:
        np.testing.assert_array_equal(mine[k].numpy(), want[k], err_msg=k)
    back = pv.llava_params_from_state_dict(cfg, mine)
    c = pv.llava_forward(cfg, raw["vision_config"], back,
                         torch.from_numpy(ids), torch.from_numpy(pixels),
                         image_token_index=LLAVA_IMG)
    d = pv.llava_forward(cfg, raw["vision_config"], from_jax_params(cfg, jq),
                         torch.from_numpy(ids), torch.from_numpy(pixels),
                         image_token_index=LLAVA_IMG)
    assert rel_err(c, d) < 2e-2  # the float leaves went through f16


@pytest.mark.parametrize("size,res", [
    ((24, 20), [[16, 16], [16, 32], [32, 16], [32, 32]]),
    ((10, 40), [[16, 32], [32, 16], [16, 64]]),
    ((30, 30), [[32, 32], [16, 16]]),
])
def test_select_best_resolution_and_unpad_equal_jax(size, res):
    assert pv.select_best_resolution(size, res) == \
        jv.select_best_resolution(size, res)
    f = np.random.default_rng(0).standard_normal((3, 8, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        pv._unpad_hw(torch.from_numpy(f), size).numpy(),
        np.asarray(jv._unpad_hw(jnp.asarray(f), size)))


def test_llava_next_packing_and_forward_equal_jax():
    raw, sd = tiny_llava_next()
    jcfg = JaxModelConfig.from_hf_dict(raw["text_config"])
    cfg = ModelConfig.from_hf_dict(raw["text_config"])
    jp = jv.llava_params_from_state_dict(jcfg, sd)
    pp = pv.llava_params_from_state_dict(cfg, torch_sd(sd))
    assert "image_newline" in pp
    vcfg = dict(raw["vision_config"],
                image_grid_pinpoints=raw["image_grid_pinpoints"])
    rng = np.random.default_rng(4)
    size = (24, 20)  # best grid 32 x 32: 2 x 2 crops + the base image
    feats = rng.standard_normal((5, 16, 64)).astype(np.float32)
    want = np.asarray(jv.llava_next_pack_features(
        jnp.asarray(feats), size, vcfg, vcfg["image_grid_pinpoints"],
        jp["image_newline"]))
    got = pv.llava_next_pack_features(
        torch.from_numpy(feats), size, vcfg, vcfg["image_grid_pinpoints"],
        pp["image_newline"])
    np.testing.assert_array_equal(got.numpy(), want)
    n_tok = want.shape[0]
    ids = rng.integers(0, 126, (1, n_tok + 8))
    ids[0, 2:2 + n_tok] = 127
    pixels = rng.standard_normal((5, 3, 16, 16)).astype(np.float32)
    want = np.asarray(jv.llava_next_forward(
        jcfg, vcfg, jp, jnp.asarray(ids), jnp.asarray(pixels), [size],
        image_token_index=127, method="jnp"))
    got = pv.llava_next_forward(cfg, vcfg, pp, torch.from_numpy(ids),
                                torch.from_numpy(pixels), [size],
                                image_token_index=127)
    assert rel_err(got, want) < 1e-4
    # the writer keeps image_newline, so a reload packs as before (JAX's
    # writer drops it: ROADMAP section 3)
    back = pv.llava_params_from_state_dict(
        cfg, pv.llava_state_dict_from_params(cfg, pp, torch.float32))
    torch.testing.assert_close(back["image_newline"], pp["image_newline"])
