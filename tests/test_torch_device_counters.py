"""The agents' device-counter form against their host-int form.

Inside an episode program (``train/blocks.make_block_fn``) the learn
counter, the TD3 time step, the Adam counts and the ring's ``cntr`` and
``beta`` are 0-d device tensors (``train/blocks.CarriedCounters``), and
every decision they make is a select: "learn or not" (the ring below
``batch_size``), SAC's dual update every 10 learns, TD3's warmup actions
and delayed actor update, the PER beta anneal.  Here one agent and ring
of each kind run 6 to 14 stores and learns on the host ints and a copy on
the device form, on the same transitions and draws, through the no-learn to
learn switch (batch 4), SAC's dual update at counters 0 and 10 (its
reference rule and Adam on log alpha), TD3's switch at time step 3 and
its actor cadence, and PER's anneal: every tensor, counter and metric is
held bit for bit after every step (Adam's bias correction is taken in
float64 from the device count and rounded to float32 once, as the host
form's Python float is), with and without the update diagnostics.  On the
device form every gate is the select a CUDA graph replays, on the CPU as
on the card.  Then the wrappers of kernels 4 and 5 route CPU tensors to
their plain versions, and the kernels' host-side pieces hold: kernel 5's
round-robin order of rotations, kernel 4's choice of path and its shared
memory.
"""

import numpy as np
import pytest
import torch

from smartcal_tpu_torch.ops import enet_lbfgs, sym_eigvals
from smartcal_tpu_torch.rl import ddpg, sac, td3
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.train.blocks import CarriedCounters, clone_ring

OBS, NA, B, MEM = 10, 2, 4, 16
# kind -> (module, config, steps): SAC to its second dual update (counter
# 10), TD3 past its warmup and through two actor updates
KINDS = {
    "sac": (sac, dict(use_hint=True), 14),
    "sac_v2": (sac, dict(use_hint=True, learn_alpha=True,
                         alpha_rule="sac_v2"), 14),
    "td3": (td3, dict(warmup=3, prioritized=True, use_hint=True,
                      n_admm=4), 8),
    "ddpg": (ddpg, {}, 6),
}



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small ops on small batches: one intra-op thread (the suite runs six
    workers on the host's cores, and oversubscribed thread pools made
    these steps ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _agent(kind):
    mod, extra, _ = KINDS[kind]
    cfg_cls = {sac: sac.SACConfig, td3: td3.TD3Config,
               ddpg: ddpg.DDPGConfig}[mod]
    cfg = cfg_cls(obs_dim=OBS, n_actions=NA, batch_size=B, mem_size=MEM,
                  **extra)
    init = {sac: sac.sac_init, td3: td3.td3_init, ddpg: ddpg.ddpg_init}[mod]
    st = init(cfg, torch.Generator().manual_seed(1), "cpu")
    return mod, cfg, st


def _floats(st, buf):
    return [t for t in sac.state_tensors(st) + [buf.priority]
            if t.is_floating_point()]


def _held(st_h, buf_h, st_d, buf_d, tag):
    got, want = _floats(st_d, buf_d), _floats(st_h, buf_h)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert torch.equal(a, b), tag
    for k in st_h.INTS:
        assert int(getattr(st_d, k)) == getattr(st_h, k), (tag, k)
    for k in st_h.OPTS:
        assert int(getattr(st_d, k).count) == getattr(st_h, k).count, (tag,
                                                                       k)
    assert int(buf_d.cntr) == buf_h.cntr, tag
    assert np.float32(buf_d.beta) == buf_h.beta, tag


@pytest.mark.parametrize("collect_diag", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_device_counters_match_host_ints(kind, collect_diag):
    """``collect_diag``: the learns also return their diagnostics, which
    the device form gates field by field (zeros where it did not learn)."""
    mod, cfg, st_h = _agent(kind)
    steps = KINDS[kind][2]
    st_d = st_h.copy_to("cpu")
    buf_h = rp.replay_init(MEM, rp.transition_spec(OBS, NA), device="cpu")
    buf_d = clone_ring(buf_h)
    counters = CarriedCounters(st_d, buf_d)
    counters.carry()
    assert buf_d.on_device and torch.is_tensor(buf_d.cntr) and st_d.carried
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    learned = []
    for i in range(steps):
        obs = rnd(OBS)
        if mod is sac:
            noise = rnd(NA)
        elif mod is td3:
            noise = (rnd(NA), rnd(NA))
        else:
            noise = rnd(NA)
        acts = [mod.choose_action(cfg, s, obs, noise) for s in (st_h, st_d)]
        assert torch.equal(acts[0], acts[1]), (kind, i)
        tr = {"state": obs, "action": acts[0],
              "reward": torch.tensor(float(rng.uniform(0, 3))),
              "new_state": rnd(OBS), "done": bool(i % 5 == 4),
              "hint": rnd(NA)}
        pri = td3.store_priority(cfg, tr["reward"]) if mod is td3 else None
        for b in (buf_h, buf_d):
            rp.replay_add(b, tr, priority=1.0 if pri is None else pri)
        if mod is sac:
            draws = {"sample_noise": rp.gumbel(MEM, g, "cpu"),
                     "noise": (rnd(B, NA), rnd(B, NA), rnd(B, NA))}
        elif mod is td3:
            draws = {"sample_noise": torch.rand(B, generator=g),
                     "smooth_noise": rnd()}
        else:
            draws = {"sample_noise": rp.gumbel(MEM, g, "cpu")}
        m_h = mod.learn(cfg, st_h, buf_h, collect_diag=collect_diag, **draws)
        m_d = mod.learn(cfg, st_d, buf_d, collect_diag=collect_diag, **draws)
        assert set(m_h) == set(m_d) and ("diag" in m_h) == collect_diag
        for k in m_h:
            pairs = (zip(m_h[k], m_d[k]) if k == "diag"
                     else [(m_h[k], m_d[k])])
            for a, b in pairs:
                assert torch.equal(torch.as_tensor(a), b), (kind, i, k)
        _held(st_h, buf_h, st_d, buf_d, (kind, i))
        learned.append(buf_h.cntr >= B)
    assert learned.count(False) == B - 1 and learned[-1]
    if mod is not ddpg:
        assert st_h.learn_counter == steps - B + 1
    if mod is td3:
        assert st_h.time_step == steps and buf_h.beta > rp.PER_BETA0
    counters.release(counters.exported().tolist())
    assert isinstance(buf_d.cntr, int) and buf_d.cntr == steps
    _held(st_h, buf_h, st_d, buf_d, (kind, "released"))


# -- kernels 4 and 5: CPU tensors take the plain versions -------------------

def test_kernel_wrappers_route_cpu_tensors_to_plain_versions():
    g = torch.Generator().manual_seed(0)
    A = torch.randn(2, 6, 5, generator=g)
    y = torch.randn(2, 6, generator=g)
    l2 = torch.tensor([0.01, 0.05, 0.02, 0.1])
    l1 = torch.tensor([0.003, 0.01, 0.05, 0.001])
    w = (torch.rand(4, 6, generator=g) > 0.5).to(torch.float32)
    before = (enet_lbfgs.launches, sym_eigvals.launches)
    got = enet_lbfgs.solve(A, y, l2, l1, w, max_iters=7)
    want = enet_lbfgs.solve_plain(A, y, l2, l1, w, max_iters=7)
    for f in ("x", "loss", "grad", "n_iters", "stop"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # two lanes per problem: each lane solved on its own group's A and y
    one = enet_lbfgs.solve_plain(A[1:], y[1:], l2[2:], l1[2:], w[2:],
                                 max_iters=7)
    assert torch.equal(got.x[2:], one.x)
    Bm = torch.randn(3, 5, 5, generator=g)
    ev = sym_eigvals.sym_eigvals(Bm)
    assert torch.equal(ev, torch.linalg.eigvalsh(0.5 * (Bm + Bm.mT)))
    assert bool((ev[:, 1:] >= ev[:, :-1]).all())
    assert (enet_lbfgs.launches, sym_eigvals.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        enet_lbfgs.solve(A.to("meta"), y.to("meta"), l2.to("meta"),
                         l1.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        sym_eigvals.sym_eigvals(Bm.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        enet_lbfgs.solve_cuda(A, y, l2, l1)
    with pytest.raises(ValueError, match="shared memory"):
        enet_lbfgs.check(torch.zeros(1, 200, 200), torch.zeros(1, 200),
                         l2[:1], l1[:1], None, 7)


# -- the kernels' host-side pieces ------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 20, 21, 78, sym_eigvals.MAX_N])
def test_round_robin_pairs_every_index_once_a_round_each_pair_once_a_sweep(
        n):
    sched = sym_eigvals.round_robin(n)
    n_p = n + n % 2
    assert sched.dtype == torch.int32
    assert tuple(sched.shape) == (n_p - 1, n_p // 2, 2)
    assert bool((sched[..., 0] < sched[..., 1]).all())
    for rnd in sched:
        assert sorted(rnd.flatten().tolist()) == list(range(n_p))
    pairs = {tuple(p) for p in sched.reshape(-1, 2).tolist()}
    assert len(pairs) == n_p * (n_p - 1) // 2
    # the kernel's threads: one per 2 x 2 block of the upper triangle
    assert (n_p // 2) * (n_p // 2 + 1) // 2 <= 1024


def test_enet_lbfgs_paths_and_shared_memory():
    # the sizes the enet env runs take the fast path, within the 48 KB a
    # block gets without opting in
    for N, M in ((20, 20), (5, 5), (32, 32), (32, 1)):
        assert enet_lbfgs.fast_path(N, M, 7)
        assert enet_lbfgs.smem_bytes(N, M, 7) <= 48 * 1024
    # wider problems or a deeper history take the wide path, A and A^T in
    # shared memory
    for N, M, m in ((33, 20, 7), (20, 33, 7), (20, 20, 9), (100, 100, 7)):
        assert not enet_lbfgs.fast_path(N, M, m)
        assert enet_lbfgs.smem_bytes(N, M, m) >= 4 * 2 * N * M
    A = torch.zeros(1, 170, 170)
    with pytest.raises(ValueError, match="shared memory"):
        enet_lbfgs.check(A, torch.zeros(1, 170), torch.ones(1),
                         torch.ones(1), None, 7)
