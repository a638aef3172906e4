"""The aux models of the PyTorch port against the JAX package: the
transformer classifier, the MLP regressor and the TSK regressor, their
buffers, and one Adam step of each trainer.

Parameters are carried from the JAX package (``interop``), so the
forwards are held at rtol 1e-5 / atol 1e-6.  The JAX trainers draw their
minibatches with ``jax.random.choice`` and the port from a
``torch.Generator``, so a trainer step is held on SHARED batch indices,
with dropout off, from a state with Adam history (3 warm-up steps: from
fresh moments a weight's first step is lr * g / (|g| + 1e-8), which turns
round-off of a tiny gradient into a full step), against the same step
written here with the JAX model and ``optax.adam``: rtol 1e-4 / atol 1e-5
(the learn-step tolerance of tests/test_torch_sac.py).  The numpy parts
(the class balancing, the buffers' pickles) are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smartcal_tpu.models import regressor as jreg
from smartcal_tpu.models import transformer as jtr
from smartcal_tpu.models import tsk as jtsk
from smartcal_tpu.train import supervised as jsup
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.models import regressor as treg
from smartcal_tpu_torch.models import transformer as ttr
from smartcal_tpu_torch.models import tsk as ttsk
from smartcal_tpu_torch.train import supervised as tsup

K, NPIX, MD = 3, 4, 2
NIN = K * (NPIX * NPIX + 8)
FWD = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops on small batches: one intra-op thread for the module, its
    fixtures included (the suite runs six workers on the host's cores, and
    their oversubscribed thread pools slowed this file's trainers several
    times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _hold_params(module, tree, **tol):
    want = interop.params_from_flax(tree, module)
    for k, v in module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k,
                                   **tol)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, NIN)).astype(np.float32)
    y = (rng.random((16, K - 1)) > 0.5).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def transformer_pair(data):
    x, _ = data
    jm = jtr.TransformerEncoder(num_layers=1, input_dim=NIN,
                                model_dim=MD * K, num_classes=K - 1,
                                num_heads=K, dropout=0.6)
    params = jax.jit(lambda k: jm.init({"params": k, "dropout": k},
                                       jnp.asarray(x[:1]),
                                       train=True)["params"])(
        jax.random.PRNGKey(0))
    tm = ttr.build_transformer(K, NPIX, MD, dropout=0.6)
    interop.transformer_params_from_flax(params, tm)
    return jm, params, tm


def test_transformer_forward_matches(data, transformer_pair):
    x, _ = data
    jm, params, tm = transformer_pair
    ref = jm.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = tm(_t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    # the heads are the attention axis: (batch, heads, heads) weights
    blk = tm.EncoderBlock_0.HeadAttention_0
    _, attn = blk(tm.Dense_0(_t(x)), return_attention=True)
    assert tuple(attn.shape) == (16, K, K)
    assert tm.LayerNorm_0.eps == 1e-6


def test_transformer_dropout_draws_from_the_generator(data):
    x, _ = data
    tm = ttr.build_transformer(K, NPIX, MD, dropout=0.6,
                               generator=torch.Generator().manual_seed(0))
    outs = [tm(_t(x), train=True,
               generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    np.testing.assert_array_equal(outs[0].detach(), outs[1].detach())
    assert not torch.equal(outs[0], outs[2])
    np.testing.assert_array_equal(tm(_t(x)).detach(),
                                  tm(_t(x), train=False).detach())


def _jax_adam_steps(loss_fn, params, batches):
    """optax.adam over ``batches``: (params, opt_state) after each."""
    opt = optax.adam(LR)
    st = opt.init(params)
    for b in batches:
        g = jax.grad(loss_fn)(params, *b)
        upd, st = opt.update(g, st)
        params = optax.apply_updates(params, upd)
    return params, st


def _batches(data, idx_sets):
    x, y = data
    return [(jnp.asarray(x[i]), jnp.asarray(y[i])) for i in idx_sets]


IDX = [np.array([0, 3, 5, 7]), np.array([1, 2, 9, 11]),
       np.array([4, 6, 8, 15]), np.array([10, 12, 13, 14])]


def test_transformer_adam_step_matches(data, transformer_pair):
    jm, params, tm = transformer_pair

    def loss_fn(p, xb, yb):
        pred = jnp.clip(jm.apply({"params": p}, xb, train=False),
                        1e-6, 1 - 1e-6)
        return -jnp.mean(yb * jnp.log(pred) + (1 - yb) * jnp.log(1 - pred))

    warm, st = _jax_adam_steps(loss_fn, params, _batches(data, IDX[:3]))
    xb, yb = _batches(data, IDX[3:])[0]
    upd, _ = optax.adam(LR).update(jax.grad(loss_fn)(warm, xb, yb), st)
    want = optax.apply_updates(warm, upd)

    interop.transformer_params_from_flax(warm, tm)
    topt = interop.adam_state_from_optax(st, tm)
    loss = tsup.transformer_step(tm, topt, _t(xb), _t(yb), LR)
    np.testing.assert_allclose(float(loss), float(loss_fn(warm, xb, yb)),
                               rtol=1e-5)
    assert topt.count == 4
    _hold_params(tm, want, **STEP)


def test_regressor_forward_and_adam_step_match(data):
    x, y = data
    xm = x[:, :3 * K + 2]
    ym = np.tanh(y - 0.5).astype(np.float32)
    jn = jreg.RegressorNet(n_outputs=K - 1, hidden=8)
    params = jax.jit(lambda k: jn.init(k, jnp.asarray(xm[:1]))["params"])(
        jax.random.PRNGKey(1))
    tn = treg.RegressorNet(3 * K + 2, K - 1, hidden=8)
    interop.regressor_params_from_flax(params, tn)
    with torch.no_grad():
        np.testing.assert_allclose(
            tn(_t(xm)).numpy(),
            np.asarray(jn.apply({"params": params}, jnp.asarray(xm))), **FWD)

    def loss_fn(p, xb, yb):
        return jnp.sum((jn.apply({"params": p}, xb) - yb) ** 2)

    batches = [(jnp.asarray(xm[i]), jnp.asarray(ym[i])) for i in IDX]
    warm, st = _jax_adam_steps(loss_fn, params, batches[:3])
    upd, _ = optax.adam(LR).update(jax.grad(loss_fn)(warm, *batches[3]), st)
    want = optax.apply_updates(warm, upd)
    interop.regressor_params_from_flax(warm, tn)
    topt = interop.adam_state_from_optax(st, tn)
    tsup.regressor_step(tn, topt, _t(batches[3][0]), _t(batches[3][1]), LR)
    _hold_params(tn, want, **STEP)


def test_tsk_forward_losses_and_adam_step_match(data):
    x, y = data
    xm = x[:, :3 * K + 2]
    ym = np.tanh(y - 0.5).astype(np.float32)
    jp = jtsk.tsk_init(jax.random.PRNGKey(2), 3 * K + 2, K - 1, n_rule=3,
                       x_sample=jnp.asarray(xm))
    tp = interop.tsk_params_from_jax(jp)
    np.testing.assert_allclose(
        ttsk.tsk_forward(tp, _t(xm)).numpy(),
        np.asarray(jtsk.tsk_forward(jp, jnp.asarray(xm))), **FWD)
    for name in ("center_difference_loss", "sigma_loss"):
        np.testing.assert_allclose(float(getattr(ttsk, name)(tp)),
                                   float(getattr(jtsk, name)(jp)), rtol=1e-5)

    def loss_fn(p, xb, yb):
        return jtsk.tsk_loss(p, xb, yb, 1e-4, 1e-4)

    batches = [(jnp.asarray(xm[i]), jnp.asarray(ym[i])) for i in IDX]
    warm, st = _jax_adam_steps(loss_fn, jp, batches[:3])
    upd, _ = optax.adam(LR).update(jax.grad(loss_fn)(warm, *batches[3]), st)
    want = optax.apply_updates(warm, upd)
    tp = interop.tsk_params_from_jax(warm)
    topt = interop.adam_state_from_optax(st, names=ttsk.TSKParams._fields)
    loss = ttsk.tsk_adam_step(tp, topt, _t(batches[3][0]),
                              _t(batches[3][1]), LR)
    np.testing.assert_allclose(float(loss), float(loss_fn(warm,
                                                          *batches[3])),
                               rtol=1e-5)
    for f in ttsk.TSKParams._fields:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f,
                                   **STEP)


def _xy(mod, rng, n=11):
    buf = mod.XYBuffer(n, (5,), (K - 1,))
    for i in range(n):
        buf.store(rng.standard_normal(5).astype(np.float32),
                  np.asarray([i % 4 == 0, i % 3 == 0], np.float32))
    return buf


def test_buffers_balance_and_pickles_bit_equal(tmp_path):
    tb, jb = _xy(ttr, np.random.default_rng(3)), _xy(jtr,
                                                    np.random.default_rng(3))
    assert tsup.label_combination_counts(tb)[1] == \
        jsup.label_combination_counts(jb)[1]
    tbal, jbal = tsup.balance_xy_buffer(tb, seed=5), \
        jsup.balance_xy_buffer(jb, seed=5)
    np.testing.assert_array_equal(tbal.x, jbal.x)
    np.testing.assert_array_equal(tbal.y, jbal.y)
    assert tbal.mem_cntr == jbal.mem_cntr
    tm, jm = tsup.merge_xy_buffers(tb, tbal), jsup.merge_xy_buffers(jb, jbal)
    np.testing.assert_array_equal(tm.x, jm.x)
    tbal.save(str(tmp_path / "t.pkl"))
    jbal.save(str(tmp_path / "j.pkl"))
    assert (tmp_path / "t.pkl").read_bytes() == \
        (tmp_path / "j.pkl").read_bytes()
    back = ttr.XYBuffer(1, (5,), (K - 1,))
    back.load(str(tmp_path / "j.pkl"))
    np.testing.assert_array_equal(back.x, jbal.x)
    carried = interop.xy_buffer_from_numpy(jbal)
    np.testing.assert_array_equal(carried.y, jbal.y)
    assert carried.mem_cntr == jbal.mem_cntr

    rng = np.random.default_rng(4)
    tr, jr = treg.TrainingBuffer(6, 3, 2), jreg.TrainingBuffer(6, 3, 2)
    for _ in range(8):
        a, b = rng.standard_normal(3), rng.standard_normal(2)
        tr.store(a, b)
        jr.store(a, b)
    tr.save_checkpoint(str(tmp_path / "t.buf"))
    jr.save_checkpoint(str(tmp_path / "j.buf"))
    assert (tmp_path / "t.buf").read_bytes() == \
        (tmp_path / "j.buf").read_bytes()
    back = treg.TrainingBuffer(1, 1, 1)
    back.load_checkpoint(str(tmp_path / "j.buf"))
    np.testing.assert_array_equal(back.filled()[0], jr.filled()[0])


def test_trainers_run_on_the_cpu_and_default_to_cuda(data):
    x, y = data
    buf = treg.TrainingBuffer(16, 3 * K + 2, K - 1)
    for a, b in zip(x[:, :3 * K + 2], np.tanh(y - 0.5)):
        buf.store(a, b)
    params, hist = tsup.train_regressor(buf, n_iter=60, batch_size=8,
                                        device="cpu")
    assert hist["losses"].shape == (60,) and np.isfinite(hist["test_mse"])
    assert hist["losses"][-10:].mean() < hist["losses"][:10].mean()
    out = tsup.train_tsk_on_buffer(buf, n_iter=40, batch_size=8,
                                   device="cpu")
    assert out["losses"].shape == (40,) and np.isfinite(out["test_mse"])
    xy = ttr.XYBuffer(16, (NIN,), (K - 1,))
    for a, b in zip(x, y):
        xy.store(a, b)
    p, h = tsup.train_transformer(xy, K=K, model_dim=MD, epochs=5,
                                  batch_size=4, device="cpu")
    assert h["losses"].shape == (5,) and np.all(np.isfinite(h["losses"]))
    assert set(p) == set(h["model"].state_dict())
    if not torch.cuda.is_available():
        for fn, args in ((tsup.train_regressor, (buf,)),
                         (tsup.train_tsk_on_buffer, (buf,)),
                         (tsup.train_transformer, (xy,)),
                         (tsup.make_hint_dataset, ()),
                         (tsup.make_transformer_dataset, ())):
            with pytest.raises(RuntimeError, match="no GPU"):
                fn(*args)
