"""AWQ quantization of the zoo's parallel-residual and llama-family
families (falcon in both layouts, cohere, phi3, gemma, gemma2, qwen3) in
the port against the JAX package's quantizer on the same float weights and
calibration ids (``tests/zoo_quant_util.py``).

Tolerances (those ``tests/test_torch_quantizer.py`` states):

* scale groups and quantizable linears equal JAX's plugin's field by
  field; every chosen grid index equal; scale vectors within 1e-5 of
  their maximum;
* recorded linear inputs of every layer within 1e-5 of their maximum;
* without the clip search: nibbles equal on at least 99.9% of entries and
  never more than 1 apart, the two quantized models' f32 logits within
  1e-3 of the float logits' scale;
* with it: clip max-vals within 1e-5 on at least 97% of entries and
  nibbles equal on at least 98% (the clip grid's round-half ties).
"""

import pytest
import torch

from zoo_quant_util import (check_scale_choices, check_taps, check_with_clip,
                            check_without_clip)

FAMILIES = ["falcon_7b_style", "falcon_new_arch", "cohere", "phi3", "gemma",
            "gemma2", "qwen3"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Six xdist workers share the host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", FAMILIES)
def test_scale_choices_equal_jax(name):
    check_scale_choices(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_calibration_taps_equal_jax(name):
    check_taps(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_whole_quantizer_without_clip_equals_jax(name):
    check_without_clip(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_whole_quantizer_near_jax(name):
    check_with_clip(name)


