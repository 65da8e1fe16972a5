"""AWQ quantization of the zoo's remaining llama-math families (stablelm,
and the remote-code baichuan, internlm2, exaone, minicpm and qwen v1) in
the port against the JAX package's quantizer on the same float weights and
calibration ids (``tests/zoo_quant_util.py``), and the plugin registry.

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

from autoawq_tpu.models.plugins import PLUGINS as JAX_PLUGINS
from autoawq_tpu_torch.models.plugins import PLUGINS, get_plugin
from zoo_quant_util import (check_scale_choices, check_taps, check_with_clip,
                            check_without_clip)

FAMILIES = ["stablelm", "baichuan", "internlm2", "exaone", "minicpm", "qwen"]
OMNI = ("qwen2_5_omni", "qwen2_5_omni_thinker", "qwen2_5_omni_text")


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


def test_registry_covers_every_jax_type_the_port_runs():
    """Every type JAX registers has a port plugin of the same name (class
    for class: the MLA and MoE types, the vision-language ones and
    Qwen2.5-Omni's among them), and nothing is left out."""
    assert set(JAX_PLUGINS) == set(PLUGINS)
    for mt, plugin in PLUGINS.items():
        assert get_plugin(mt) is plugin
        assert plugin.__name__ == JAX_PLUGINS[mt].__name__, mt
    for mt in OMNI:
        assert PLUGINS[mt].__name__ == "LlamaFamilyPlugin"
