"""Mixtral's experts in every recipe the JAX package quantizes them in, and
``ops.linear`` at a device index route by route, JAX package vs port, on
tiny-moe (float32).

The JAX side makes and quantizes the params (``MoEQuantConfig`` on
``moe_linear_filter``'s leaves, the gate float); ``params_from_jax_numpy``
carries them across. The same numpy tokens go through both packages (the
JAX package's XLA routes on the CPU, the port's plain versions):

- the ``dense`` forward on a [2, 8] batch and the ``gathered`` decode
  forward of one token (each routed expert's linears at a device index):
  ``rtol = atol = 2e-3`` (``tests/test_torch_mixtral.py``'s bound). The JAX
  package's gathered step runs op by op (``jax.disable_jit``, as
  ``tests/test_torch_recipes.py`` runs float8dq-tensor): its compiled CPU
  program disagrees with its own op-by-op run by up to 0.12 in the logits
  wherever activations are quantized to e4m3 (float8dq-row,
  float8dq-tensor), while the port agrees with the op-by-op run to 1e-6
  (measured; every other recipe and mode: both runs within 3e-6). 8da4w
  runs on ``WIDE`` (tiny-moe at dim and FFN 512): the JAX package packs its
  weight TILED, the layout of its centred route, only where ``K/2`` is a
  multiple of ``8·g``; at tiny-moe's K = 64 it is PLAIN and takes the
  generic route.
  ``float8dq-tensor`` runs ``gathered`` only: the JAX package's dense mode
  scans the layers and cannot split one scale over a stacked leaf
  (``test_recipes_the_moe_path_leaves_out``);
- ``linear`` at a device index equals the host index, on the merged expert
  stacks of w1 and w2 (``tests/test_torch_mixtral.py::
  test_linear_at_a_device_index_equals_the_host_index``'s check);
- the route a device index takes, for every route of the dispatch table:
  the routes of ``ops.qlinear.INDEXED_ENTRIES`` take the stack whole and, on
  the card, launch the indexed entry named there (the JAX package's
  ``_stacked_linear``, ``torchao_tpu/ops/qlinear.py:125-257``, sends the same
  weights to its scalar-prefetch kernels); every other route takes the entry
  first (``index_leading``: the JAX package's ``take_layer``). The entries are
  held to the sources' ``TT_EXPORT`` names and to what the wrappers launch.

Left out of the MoE path, by the JAX package's own limits: ``fp6`` and
``fp6-packed`` (its fp6 packing takes at most one leading axis: a 4-D expert
leaf does not quantize) and ``float8dq-tensor``'s prefill (above). Card tests
of the indexed forms: ``tests/test_torch_kernel_build.py -m cuda -k indexed``.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchao_tpu.models.mixtral as JX
import torchao_tpu_torch.models.mixtral as TX
from test_torch_quant import jax_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torchao_tpu.prototype.moe_quant import MoEQuantConfig as JMoE
from torchao_tpu.quantization import quant_api as JQ
from torchao_tpu.quantization.granularity import PerRow as JPerRow
from torchao_tpu.quantization.granularity import PerTensor as JPerTensor
from torchao_tpu.quantization.quant_primitives import MappingType as JMapping
from torchao_tpu_torch.convert import params_from_jax_numpy
from torchao_tpu_torch.kernels import _build, _qmm
from torchao_tpu_torch.ops import qlinear
from torchao_tpu_torch.quantization import quant_api as TQ
from torchao_tpu_torch.quantization.transform_module import get_quantize_handler
from torchao_tpu_torch.utils import DeviceIndex

TOL = 2e-3
WIDE = {**JX.moe_configs["tiny-moe"], "dim": 512, "intermediate_size": 512, "n_head": 8}
RECIPES = {
    "int8dq": JQ.Int8DynamicActivationInt8WeightConfig(),
    "int8dq-wo-decode": JQ.Int8DynamicActivationInt8WeightConfig(weight_only_decode=True),
    "int8dq-asym": JQ.Int8DynamicActivationInt8WeightConfig(act_mapping_type=JMapping.ASYMMETRIC),
    "float8wo": JQ.Float8WeightOnlyConfig(),
    "float8dq-row": JQ.Float8DynamicActivationFloat8WeightConfig(granularity=JPerRow()),
    "float8dq-tensor": JQ.Float8DynamicActivationFloat8WeightConfig(granularity=JPerTensor()),
    "8da4w-32": JQ.Int8DynamicActivationInt4WeightConfig(group_size=32),
    "int4wo-32-hqq": JQ.Int4WeightOnlyConfig(group_size=32, use_hqq=True),
    "uintx-4-64": JQ.UIntXWeightOnlyConfig("uint4", 64),
    "int4dq-4": JQ.Int4DynamicActivationInt4WeightConfig(),
}
GATHERED_ONLY = {"float8dq-tensor"}
CASES = [(r, m) for r in RECIPES for m in ("dense", "gathered")
         if m == "gathered" or r not in GATHERED_ONLY]

# the route a stacked weight takes at a device index, mirroring the JAX package's
# _stacked_linear: (the port's route, its indexed C entry), or None where the entry
# is taken first (index_leading) and the weight runs unstacked
WANT_ROUTE = {
    "int8wo": ("int8_weight_only", "tt_qmm_gemv_indexed"),
    "int8dq": ("int8_dyn_act_int8_weight", "tt_qmm_gemv_indexed"),
    "int8dq-wo-decode": ("int8_dyn_act_int8_weight", "tt_qmm_gemv_indexed"),
    "int8dq-asym": None,
    "float8wo": ("fp8_weight", "tt_fp8_mixed_gemv_indexed"),
    "float8dq-row": ("fp8_weight", "tt_fp8_mixed_gemv_indexed"),
    "float8dq-tensor": ("fp8_weight", "tt_fp8_mixed_gemv_indexed"),
    "8da4w-32": ("8da4w_centered_int4", "tt_int4_gemv_indexed"),
    "int4wo-32": ("int4_weight_only", "tt_int4_gemv_indexed"),
    "int4wo-32-hqq": ("int4_weight_only", "tt_int4_gemv_indexed"),
    "fp6": ("fp6_dual", "tt_fp6_dual_gemv_indexed"),
    "fp6-packed": ("fpx_weight", "tt_fp6_gemv_indexed"),
    "uintx-4-64": None,
    "int4dq-4": None,
}
# the routes that take the entry first: no scalar-prefetch kernel in the JAX package
# (w4a8 runs only on the card, where K10's probe accepts the weight)
TAKE_ENTRY_ROUTES = {"w4a8_int4_weight", "laqt_generic", "dequantize"}


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 512, shape).astype(np.int32)


def _config(recipe):
    return WIDE if recipe.startswith("8da4w") else JX.moe_configs["tiny-moe"]


def _jax_model(recipe, mode="dense"):
    return JX.MoETransformer(JX.MoEModelArgs(**_config(recipe)), jnp.float32, moe_mode=mode)


def _port_model(recipe, mode):
    return TX.MoETransformer(TX.MoEModelArgs(**_config(recipe)), torch.float32, "cpu", mode)


@functools.lru_cache(maxsize=None)
def _jax_params(recipe):
    model = _jax_model(recipe)
    raw = jax.jit(model.init_params)(jax.random.PRNGKey(0))
    cfg = JMoE(RECIPES[recipe])
    return jax.jit(lambda p: JQ.quantize_(p, cfg, filter_fn=JX.moe_linear_filter))(raw)


@functools.lru_cache(maxsize=None)
def _port_params(recipe):
    return params_from_jax_numpy(jax_to_numpy(_jax_params(recipe)), device="cpu")


def _inputs(mode):
    return _tokens(9, (2, 8)) if mode == "dense" else np.array([[7]], np.int32)


@pytest.mark.parametrize("recipe,mode", CASES)
def test_forward_matches_jax(recipe, mode):
    model = _jax_model(recipe, mode)
    toks = _inputs(mode)
    with jax.disable_jit(mode == "gathered"):
        want = np.asarray(model(_jax_params(recipe), jnp.asarray(toks))[0])
    got, _ = _port_model(recipe, mode)(_port_params(recipe), torch.from_numpy(toks).long())
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_linear_at_a_device_index_equals_the_host_index(recipe):
    """``ops.linear`` at a device index (``DeviceIndex``, a tensor) over the
    merged w1 and w2 stacks equals the host-int index, bit for bit."""
    moe = _port_params(recipe)["layers"]["block_sparse_moe"]
    gen = torch.Generator().manual_seed(2)
    for name in ("w1", "w2"):
        w = TX._merge_expert_axis(moe[name])
        x = torch.randn(1, w.shape[-1], generator=gen)
        idx = torch.tensor([2, 1])
        for f in (DeviceIndex(idx[0], 4), DeviceIndex(idx[1:], 0), torch.tensor(5)):
            host = int(f.base + f.index) if isinstance(f, DeviceIndex) else int(f)
            assert torch.equal(qlinear.linear(x, w, layer_idx=f),
                               qlinear.linear(x, w, layer_idx=host)), (recipe, name)


# ------------------------------------------------------------ route table --

_PORT_CONFIGS = {
    "int8wo": TQ.Int8WeightOnlyConfig(),
    "int4wo-32": TQ.Int4WeightOnlyConfig(group_size=32),
    "fp6": TQ.FPXWeightOnlyConfig(ebits=3, mbits=2),
    "fp6-packed": TQ.FPXWeightOnlyConfig(ebits=3, mbits=2, runtime="packed"),
}


def _stack(recipe):
    """A stacked weight of ``recipe``: the merged w1 stack of its MoE params
    above, or (int8wo and int4wo-32, held in ``tests/test_torch_mixtral.py``,
    and fp6, whose 4-D expert leaves the JAX package does not quantize) a
    [3, 256, 512] layer stack quantized by the port."""
    if recipe in RECIPES:
        return TX._merge_expert_axis(_port_params(recipe)["layers"]["block_sparse_moe"]["w1"])
    cfg = _PORT_CONFIGS[recipe]
    w = torch.randn((3, 256, 512), generator=torch.Generator().manual_seed(4)) / 16
    return get_quantize_handler(cfg)(w, cfg)


def _exported():
    return set(re.findall(r"TT_EXPORT\s+\w[\w\s*]*?\b(tt_\w+)\s*\(",
                          "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))))


@pytest.mark.parametrize("recipe", list(WANT_ROUTE))
def test_device_index_route_of_every_recipe(recipe):
    """The route a device index takes (the table above, the JAX package's
    ``_stacked_linear`` route by route), and the C entry it launches on the
    card: an indexed entry the sources export and the ctypes table binds."""
    w = _stack(recipe)
    x = torch.zeros((1, w.shape[-1]))
    ix = DeviceIndex(torch.tensor(1), 0)
    route = qlinear._indexed_route(x, w, ix)
    want = WANT_ROUTE[recipe]
    if want is None:
        assert route is None
        assert qlinear.route_of(x, w, 1) in TAKE_ENTRY_ROUTES
    else:
        assert (route, qlinear.INDEXED_ENTRIES[route]) == want
        assert want[1] in _exported() and want[1] in _build.SIGNATURES


def test_the_route_table_covers_the_dispatch():
    """Every registered route either takes a device index whole (with its
    indexed entry) or takes the entry first; the indexed entries are the ones
    the wrappers launch."""
    names = {name for name, _, _ in qlinear._DISPATCH}
    assert set(qlinear.INDEXED_ENTRIES) | (TAKE_ENTRY_ROUTES - {"dequantize"}) == names
    assert not set(qlinear.INDEXED_ENTRIES) & TAKE_ENTRY_ROUTES
    assert {f"{_qmm.gemv1_entry(k)}_indexed" for k in (_qmm.K6_BF16_I8, _qmm.K7_I8_I8)} == {
        qlinear.INDEXED_ENTRIES["int8_weight_only"]}
    assert {f"{_qmm.gemv1_entry(k)}_indexed" for k in (_qmm.K8_BF16_E4M3, _qmm.K8_E4M3_E4M3)} == {
        qlinear.INDEXED_ENTRIES["fp8_weight"]}
    from torchao_tpu_torch.kernels import fp6_matmul, int4_matmul

    for route, mod in (("int4_weight_only", int4_matmul), ("fp6_dual", fp6_matmul),
                       ("fpx_weight", fp6_matmul)):
        assert f'"{qlinear.INDEXED_ENTRIES[route]}"' in open(mod.__file__).read(), route
    assert set(qlinear.INDEXED_ENTRIES.values()) <= _exported()


def test_recipes_the_moe_path_leaves_out():
    """The JAX package's limits that keep recipes off the MoE path: its fp6
    packing takes one leading axis at most (a 4-D expert leaf raises), and
    its dense mode cannot scan layers whose leaf holds one per-tensor scale
    (the gathered decode runs)."""
    model = _jax_model("fp6")
    raw = jax.jit(model.init_params)(jax.random.PRNGKey(0))
    for cfg in (JQ.FPXWeightOnlyConfig(ebits=3, mbits=2),
                JQ.FPXWeightOnlyConfig(ebits=3, mbits=2, runtime="packed")):
        with pytest.raises(ValueError):
            JQ.quantize_(raw, JMoE(cfg), filter_fn=JX.moe_linear_filter)
    params = _jax_params("float8dq-tensor")
    model.moe_mode = "dense"
    with pytest.raises(ValueError, match="leading axis"):
        model(params, jnp.asarray(_inputs("dense")))
