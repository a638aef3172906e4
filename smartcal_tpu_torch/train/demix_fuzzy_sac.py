"""Fuzzy-controller demixing SAC trainer (counterpart of
smartcal_tpu/train/demix_fuzzy_sac.py; reference
``demixing_fuzzy/main_sac.py``).

The action is the 24(K-1)+8 membership-trapezoid parameters of the
Mamdani controller; ``FuzzyDemixingEnv`` updates the controller, scores
each outlier's priority against its cutoff and calibrates the selected
ones.  Metadata is 5K+2; the influence map is optional (``--use_influence``;
without it the CNN branch is dropped).  Rewards above 0.01 are scaled by
10, and the first ``--warmup`` episodes act randomly.  The backend is the
calibration trainers' (``calib_td3.build_backend``).

Usage:
    python -m smartcal_tpu_torch.train.demix_fuzzy_sac --iteration 1000
        [--use_hint] [--use_influence] [--small] [--device cpu]
"""

import argparse

import numpy as np

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs.demixing_fuzzy import FuzzyDemixingEnv
from smartcal_tpu_torch.rl import sac
from smartcal_tpu_torch.runtime.atomic import safe_pickle_load
from smartcal_tpu_torch.train.blocks import (add_obs_args, add_runtime_args,
                                             diag_from_args)
from smartcal_tpu_torch.train.calib_td3 import build_backend
from smartcal_tpu_torch.train.demix_sac import (add_device_arg, flattener,
                                                obs_shape, run_warmup_loop)

MIN_POSITIVE_REWARD = 0.01      # reference main_sac.py:70
REWARD_SCALE_POS = 10.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iteration", type=int, default=1000)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=30)
    p.add_argument("--K", type=int, default=6)
    p.add_argument("--memory", type=int, default=30000)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--use_hint", action="store_true")
    p.add_argument("--use_influence", action="store_true")
    p.add_argument("--stations", type=int, default=14)
    p.add_argument("--npix", type=int, default=128)
    p.add_argument("--small", action="store_true")
    p.add_argument("--load", action="store_true")
    p.add_argument("--prefix", type=str, default="demix_fuzzy_sac")
    add_device_arg(p)
    add_obs_args(p)
    add_runtime_args(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    backend = build_backend(args, dev)
    env = FuzzyDemixingEnv(K=args.K, provide_hint=args.use_hint,
                           provide_influence=args.use_influence,
                           backend=backend, seed=args.seed, device=dev)
    n_actions = env.n_actions
    obs_dim, img_shape = obs_shape(backend.npix, env.n_metadata,
                                   args.use_influence)
    agent_cfg = sac.SACConfig(
        obs_dim=obs_dim, n_actions=n_actions, gamma=0.99, tau=0.005,
        batch_size=args.batch_size, mem_size=args.memory, lr_a=3e-4,
        lr_c=3e-4, alpha=0.03, hint_threshold=0.01, admm_rho=1.0,
        use_hint=args.use_hint, hint_distance="kld", img_shape=img_shape,
        use_image=args.use_influence)
    agent = sac.SACAgent(agent_cfg, seed=args.seed, name_prefix=args.prefix,
                         device=dev, collect_diag=diag_from_args(args))
    scores = []
    if args.load:
        agent.load_models()
        scores = safe_pickle_load(f"{args.prefix}_scores.pkl", default=[])

    def scale_reward(r):
        return r * REWARD_SCALE_POS if r > MIN_POSITIVE_REWARD else r

    return run_warmup_loop(env, agent, args, scores,
                           flattener(args.use_influence), n_actions,
                           scale_reward, rng)


if __name__ == "__main__":
    main()
