"""The port's actor/critic networks against the JAX package's flax modules
on carried weights (``interop.params_from_flax``).

Images of 16² and 15² take the two SAME paddings of a stride-2 conv (16:
(1, 2), 15: (2, 2)); one observation (1-D) and a batch (2-D) go through
each, with and without the CNN branch; the MLP pair too.  Forward passes
are held at rtol 1e-5 / atol 1e-6.  Run with ``-s`` to see the measured
maxima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.rl import networks as jn
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.rl import networks as tn

RTOL, ATOL = 1e-5, 1e-6
META, NA = 11, 4


def close(name, got, want, rtol=RTOL, atol=ATOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want)
    print(f"{name}: max abs err {err.max():.3e}, max rel err "
          f"{(err / np.maximum(np.abs(want), 1e-30)).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def carried(flax_mod, torch_mod, *inputs, seed=0):
    params = jax.jit(flax_mod.init)(jax.random.PRNGKey(seed),
                                    *inputs)["params"]
    torch_mod.load_state_dict(interop.params_from_flax(params, torch_mod))
    return params


def _obs(rng, n, obs_dim):
    shape = (obs_dim,) if n is None else (n, obs_dim)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("side, use_image", [(16, True), (15, True),
                                             (16, False)])
def test_image_meta_actor_and_critic_match(side, use_image):
    rng = np.random.default_rng(side)
    obs_dim = side * side + META
    fa = jn.SplitImageMetaActor(img_shape=(side, side), n_actions=NA,
                                use_image=use_image)
    fc = jn.SplitImageMetaCritic(img_shape=(side, side), use_image=use_image)
    ta = tn.SplitImageMetaActor((side, side), obs_dim, NA, use_image=use_image)
    tc = tn.SplitImageMetaCritic((side, side), obs_dim, NA,
                                 use_image=use_image)
    pa = carried(fa, ta, jnp.zeros((1, obs_dim)))
    pc = carried(fc, tc, jnp.zeros((1, obs_dim)), jnp.zeros((1, NA)), seed=1)
    for n in (None, 5):                       # one observation, a batch
        obs = _obs(rng, n, obs_dim)
        act = rng.uniform(-1, 1, obs.shape[:-1] + (NA,)).astype(np.float32)
        mu, ls = jax.jit(fa.apply)({"params": pa}, obs)
        tmu, tls = ta(torch.from_numpy(obs))
        tag = f"side={side} image={use_image} batch={n}"
        close(f"actor mu {tag}", tmu, mu)
        close(f"actor logsigma {tag}", tls, ls)
        close(f"critic q {tag}", tc(torch.from_numpy(obs),
                                    torch.from_numpy(act)),
              jax.jit(fc.apply)({"params": pc}, obs, act))


def test_mlp_actor_and_critic_match():
    rng = np.random.default_rng(3)
    fa, fc = jn.MLPActor(NA), jn.MLPCritic()
    ta, tc = tn.MLPActor(6, NA), tn.MLPCritic(6, NA)
    pa = carried(fa, ta, jnp.zeros((1, 6)))
    pc = carried(fc, tc, jnp.zeros((1, 6)), jnp.zeros((1, NA)), seed=1)
    for n in (None, 7):
        obs = _obs(rng, n, 6)
        act = rng.uniform(-1, 1, obs.shape[:-1] + (NA,)).astype(np.float32)
        mu, ls = jax.jit(fa.apply)({"params": pa}, obs)
        tmu, tls = ta(torch.from_numpy(obs))
        close(f"mlp actor mu batch={n}", tmu, mu)
        close(f"mlp actor logsigma batch={n}", tls, ls)
        close(f"mlp critic q batch={n}",
              tc(torch.from_numpy(obs), torch.from_numpy(act)),
              jax.jit(fc.apply)({"params": pc}, obs, act))


def test_same_padding_is_flax_and_unbatched_groupnorm_is_per_row():
    """The pads are jax's SAME pads (the asymmetric (1, 2) at 128), and an
    unbatched map's GroupNorm differs from the batched one's (flax takes
    the leading axis of an unbatched map for the batch)."""
    for n in (128, 64, 16, 15, 8):
        pads = jax.lax.padtype_to_pads((n,), (5,), (2,), "SAME")[0]
        assert tn._same_pads(n, 5, 2) == tuple(pads), n
    assert tn._same_pads(128, 5, 2) == (1, 2)
    gn = tn.GroupNorm(2, 4, eps=1e-6)
    x = torch.randn(4, 6, 5, generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(gn(x), gn(x[None])[0], atol=1e-3)
    fx = jn.nn.GroupNorm(num_groups=2)
    params = fx.init(jax.random.PRNGKey(0), jnp.zeros((6, 5, 4)))
    close("unbatched groupnorm", gn(x),
          np.moveaxis(np.asarray(fx.apply(params, np.moveaxis(
              x.numpy(), 0, -1))), -1, 0))


def test_params_from_flax_rejects_a_mismatch():
    fa = jn.SplitImageMetaActor(img_shape=(16, 16), n_actions=NA)
    params = jax.jit(fa.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16 * 16 + META)))
    with pytest.raises(ValueError):
        interop.params_from_flax(params["params"], tn.SplitImageMetaActor(
            (16, 16), 16 * 16 + META, NA, use_image=False))
    with pytest.raises(ValueError):
        interop.params_from_flax(params["params"], tn.SplitImageMetaActor(
            (16, 16), 16 * 16 + META, NA + 1))


def test_init_follows_the_flax_distributions():
    """Dense U(+-1/sqrt(out)), final layers U(+-0.003), convs lecun normal
    truncated at 2 std with zero bias, norms at (1, 0)."""
    net = tn.SplitImageMetaActor((32, 32), 32 * 32 + META, NA,
                                 generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    head = sd["ImageMetaActor_0.Dense_4.weight"]
    assert head.abs().max() <= 0.003 and head.abs().max() > 0.002
    w = sd["ImageMetaActor_0.Dense_2.weight"]          # (256, 16+2048)
    assert w.abs().max() <= 1 / 16 and w.abs().max() > 0.06
    conv = sd["ImageMetaActor_0.InfluenceCNN_0.Conv_1.weight"]
    std = (1 / (16 * 25)) ** 0.5
    assert conv.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7
    assert abs(float(conv.std()) - std) < 0.1 * std
    assert not sd["ImageMetaActor_0.InfluenceCNN_0.Conv_1.bias"].any()
    assert (sd["ImageMetaActor_0.LayerNorm_0.weight"] == 1).all()


def test_gaussian_sample_and_log_prob_match():
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((6, NA)).astype(np.float32)
    ls = rng.uniform(-2, 0.5, (6, NA)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.normal(key, mu.shape))
    a, lp = jn.gaussian_sample(mu, ls, key)
    ta, tlp = tn.gaussian_sample(torch.from_numpy(mu), torch.from_numpy(ls),
                                 torch.from_numpy(noise))
    close("gaussian_sample action", ta, a)
    close("gaussian_sample log-prob", tlp, lp, rtol=1e-5, atol=1e-5)
    acts = np.clip(np.asarray(a), -0.999, 0.999)
    want = jn.tanh_gaussian_log_prob(mu, ls, acts)
    got = tn.tanh_gaussian_log_prob(torch.from_numpy(mu),
                                    torch.from_numpy(ls),
                                    torch.from_numpy(acts))
    close("tanh_gaussian_log_prob", got, want, rtol=1e-5, atol=1e-4)
    np_lp = tn.tanh_gaussian_log_prob_np(mu, ls, acts)
    np.testing.assert_allclose(np_lp, jn.tanh_gaussian_log_prob_np(
        mu, ls, acts), rtol=0, atol=0)
    close("tanh_gaussian_log_prob vs numpy", got, np_lp, rtol=1e-5,
          atol=1e-4)


def test_flatten_obs_matches():
    rng = np.random.default_rng(2)
    d = {"img": rng.standard_normal((4, 4)), "sky": rng.standard_normal(
        (3, 7))}
    np.testing.assert_array_equal(tn.flatten_obs(d), jn.flatten_obs(d))
    e = {"infmap": rng.standard_normal((2, 4, 4)),
         "metadata": rng.standard_normal((2, 5))}
    np.testing.assert_array_equal(tn.flatten_obs_batch(e),
                                  jn.flatten_obs_batch(e))
