"""The port's model and weight bridge against the JAX package, on the CPU.

Same weights through m2trans_tpu_torch.train.jax_params, same numpy
inputs and the same Config (the port's; both packages read its fields):
f32 parity vs ``m2trans_apply(..., ComputePolicy())`` at 1e-5 (the pattern
of tests/test_torch_parity.py), and the bf16 plain path vs the golden
output of the JAX bf16 Pallas kernels (the tolerance of
tests/test_golden.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models import m2trans_apply as jax_apply
from m2trans_tpu.models.m2trans import ComputePolicy as JaxPolicy
from m2trans_tpu.models.m2trans import cftm_apply as jax_cftm
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    cftm_apply,
    init_m2trans,
    m2trans_apply,
    m2trans_apply_microbatched,
    policy_from_config,
)
from m2trans_tpu_torch.train.convert import (
    load_reference_state_dict,
    reference_state_dict,
)
from m2trans_tpu_torch.train.jax_params import module_from_params, params_from_module

from torch_ref import TBlock, TorchM2Trans

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("scale,hw", [(2, (24, 40)), (3, (32, 32)),
                                      (4, (20, 28))])
def test_f32_matches_jax(scale, hw):
    cfg = Config(scale=scale, n_feats=8, n_blocks=2)
    params = jax_init(jax.random.PRNGKey(scale), cfg)
    model = module_from_params(params, cfg)
    x = np.random.default_rng(scale).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_apply(params, jnp.asarray(x), cfg, policy=JaxPolicy()))
    got = m2trans_apply(model, torch.from_numpy(x), cfg, ComputePolicy()).detach().numpy()
    assert got.shape == want.shape == (2, hw[0] * scale, hw[1] * scale, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_f32_matches_jax_flagship_width():
    """One block at n_feats=64: branch widths 16/64/256/256."""
    cfg = Config(scale=4, n_feats=64, n_blocks=1)
    params = jax_init(jax.random.PRNGKey(7), cfg)
    model = module_from_params(params, cfg)
    x = np.random.default_rng(7).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_apply(params, jnp.asarray(x), cfg, policy=JaxPolicy()))
    got = m2trans_apply(model, torch.from_numpy(x), cfg, ComputePolicy()).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_plain_matches_pallas_golden():
    """The bf16 path (plain K1/K2 on CPU tensors) vs the JAX bf16 Pallas
    kernels' golden output."""
    cfg = Config(scale=4, n_feats=64, n_blocks=1)
    params = jax_init(jax.random.PRNGKey(42), cfg)
    model = module_from_params(params, cfg)
    x = np.array(jax.random.uniform(jax.random.PRNGKey(43), (2, 32, 32, 3)))
    pol = ComputePolicy(dtype=torch.bfloat16, use_kernels=True)
    got = m2trans_apply(model, torch.from_numpy(x), cfg, pol).detach().float().numpy()
    want = np.load(os.path.join(GOLDEN, "m2trans_x4_bf16_pallas.npy"))
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert float(np.abs(got - want).mean()) < 2e-3


def test_bf16_cftm_matches_jax_fused():
    """One bf16 CFTM vs the JAX fused CFTM (interpret-mode kernels)."""
    cfg = Config(scale=2, n_feats=16, n_blocks=1)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    model = module_from_params(params, cfg)
    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 16)).astype(np.float32)
    pol = JaxPolicy(dtype=jnp.bfloat16, precision=None, use_pallas=True)
    want = np.asarray(jax_cftm(params["body"][0],
                               jnp.asarray(x).astype(jnp.bfloat16),
                               policy=pol)).astype(np.float32)
    with torch.no_grad():
        got = cftm_apply(model.body[0], torch.from_numpy(x).bfloat16(),
                         policy=ComputePolicy(dtype=torch.bfloat16))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    assert float(np.abs(got - want).mean()) < 5e-3


def test_weight_bridge_roundtrip_exact():
    """JAX params -> port -> reference state_dict -> JAX params is exact,
    and the port's state_dict loads strict into the reference-format
    torch oracle."""
    cfg = Config(scale=4, n_feats=8, n_blocks=2)
    params = jax_init(jax.random.PRNGKey(1), cfg)
    model = module_from_params(params, cfg)
    back = params_from_module(model, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    oracle = TorchM2Trans(scale=4, n_feats=8, n_blocks=2)
    oracle.load_state_dict(reference_state_dict(model), strict=True)


def test_reference_state_dict_loads_strict():
    """A reference-format state dict (torch_ref's TorchM2Trans, with the
    DataParallel prefix) loads strict=True into the port."""
    torch.manual_seed(5)
    tm = TorchM2Trans(scale=3, n_feats=8, n_blocks=2)
    for mod in tm.modules():
        if isinstance(mod, TBlock):
            mod.reset_parameters_like_reference()
    cfg = Config(scale=3, n_feats=8, n_blocks=2)
    model = init_m2trans(cfg, seed=0)
    load_reference_state_dict(
        model, {f"module.{k}": v for k, v in tm.state_dict().items()})
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def test_seeded_init_is_deterministic_and_distributed_like_torch():
    cfg = Config(scale=4, n_feats=16, n_blocks=1)
    a, b = init_m2trans(cfg, seed=3), init_m2trans(cfg, seed=3)
    c = init_m2trans(cfg, seed=4)
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    head = a.head.weight.detach()
    assert float(head.abs().max()) <= (3 * 9) ** -0.5
    assert not torch.equal(a.head.weight, c.head.weight)
    qkv = a.body[0].attn3.qkv_conv.weight.detach()  # N(0, sqrt(2 / (3 * 64)))
    assert abs(float(qkv.std()) - (2 / 192) ** 0.5) < 0.01
    assert a.sub_mean.weight.requires_grad is False


def test_policy_and_microbatch():
    cfg = Config(scale=2, n_feats=8, n_blocks=1, dtype="bfloat16",
                 use_pallas=True)
    assert policy_from_config(cfg) == ComputePolicy(torch.bfloat16, True)
    assert policy_from_config(Config()) == ComputePolicy()
    model = init_m2trans(cfg, seed=1)
    x = torch.rand(16, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    pol = ComputePolicy()
    whole = m2trans_apply(model, x, cfg, pol)
    chunks = m2trans_apply_microbatched(model, x, cfg, pol, micro_batch=8)
    torch.testing.assert_close(chunks, whole, rtol=0, atol=0)
