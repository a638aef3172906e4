"""Demixing (direction selection) TD3 trainer (counterpart of
smartcal_tpu/train/demix_td3.py; reference ``demixing_rl/main_td3.py`` +
``demix_td3.py``).

CNN+metadata TD3 with prioritized replay and the adaptive-rho ADMM hint
loop in the actor update; gamma 0.99, batch 64, tau 0.005, memory 4096,
lr 1e-3, actor every 2 learns, warm-up 200 steps, noise 0.1, admm_rho
0.1.  As in the JAX package, the agent emits the env's full K-dimensional
action (the reference builds it with ``n_actions=K-1`` and the env reads
``action[K-1]``), and exploration in the warm-up is the agent's own
(``td3.choose_action``): the driver loop injects no random actions.

Usage:
    python -m smartcal_tpu_torch.train.demix_td3 --iteration 30 --seed 0
        [--use_hint] [--provide_influence] [--small | --light | --medium]
        [--device cpu]
"""

import argparse

import numpy as np

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs.demixing import DemixingEnv
from smartcal_tpu_torch.rl import td3
from smartcal_tpu_torch.runtime.atomic import safe_pickle_load
from smartcal_tpu_torch.train.blocks import (add_obs_args, add_runtime_args,
                                             diag_from_args)
from smartcal_tpu_torch.train.demix_sac import (add_device_arg, flattener,
                                                make_backend, obs_shape,
                                                run_warmup_loop)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iteration", type=int, default=30,
                   help="max episodes (reference n_games=30)")
    p.add_argument("--steps", type=int, default=7)
    p.add_argument("--K", type=int, default=6)
    p.add_argument("--warmup", type=int, default=200,
                   help="agent warmup steps (pure noise actions)")
    p.add_argument("--use_hint", action="store_true")
    p.add_argument("--provide_influence", action="store_true")
    p.add_argument("--stations", type=int, default=14)
    p.add_argument("--npix", type=int, default=128)
    p.add_argument("--small", action="store_true")
    p.add_argument("--light", action="store_true",
                   help="see demix_sac --light")
    p.add_argument("--medium", action="store_true",
                   help="see demix_sac --medium")
    p.add_argument("--load", action="store_true")
    p.add_argument("--prefix", type=str, default="demix_td3")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--memory", type=int, default=4096)
    add_device_arg(p)
    add_obs_args(p)
    add_runtime_args(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    backend = make_backend(args, dev)
    env = DemixingEnv(K=args.K, provide_hint=args.use_hint,
                      provide_influence=args.provide_influence,
                      backend=backend, seed=args.seed, device=dev)
    obs_dim, img_shape = obs_shape(backend.npix, 3 * args.K + 2,
                                   args.provide_influence)
    agent_cfg = td3.TD3Config(
        obs_dim=obs_dim, n_actions=args.K, gamma=0.99, tau=0.005,
        batch_size=args.batch_size, mem_size=args.memory,
        lr_a=1e-3, lr_c=1e-3, update_actor_interval=2, warmup=args.warmup,
        noise=0.1, use_hint=args.use_hint, admm_rho=0.1, prioritized=True,
        error_clip=100.0, img_shape=img_shape)
    agent = td3.TD3Agent(agent_cfg, seed=args.seed, name_prefix=args.prefix,
                         device=dev, collect_diag=diag_from_args(args))
    scores = []
    if args.load:
        agent.load_models()
        scores = safe_pickle_load(f"{args.prefix}_scores.pkl", default=[])

    # the agent's own warm-up supplies the exploration noise
    args.warmup = 0
    return run_warmup_loop(env, agent, args, scores,
                           flattener(args.provide_influence), args.K,
                           lambda r: r, rng)


if __name__ == "__main__":
    main()
