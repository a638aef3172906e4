"""Calibration (ADMM-rho tuning) DDPG trainer (counterpart of
smartcal_tpu/train/calib_ddpg.py).

Mirrors ``calibration/main_ddpg.py``: the CNN+metadata DDPG agent
(Ornstein-Uhlenbeck exploration noise, one critic, target actor and
critic) on CalibEnv episodes, per-episode checkpointing; the episode loop
and flags are ``train/calib_td3.py``'s.

Usage:
    python -m smartcal_tpu_torch.train.calib_ddpg --episodes 30 [--small]
        [--device cpu]
"""

from smartcal_tpu_torch.rl import ddpg
from smartcal_tpu_torch.train.blocks import (diag_from_args,
                                             train_obs_from_args)
from smartcal_tpu_torch.train.calib_td3 import run, setup


def agent_config(npix, M) -> ddpg.DDPGConfig:
    """The trainer's agent (calibration/main_ddpg.py's): obs = npix² image
    + (M+1) x 7 sky table, 2M actions, batch 32, a 1000-slot ring."""
    return ddpg.DDPGConfig(
        obs_dim=npix * npix + (M + 1) * 7, n_actions=2 * M, gamma=0.99,
        tau=0.005, batch_size=32, mem_size=1000, lr_a=1e-3, lr_c=1e-3,
        img_shape=(npix, npix))


def main(argv=None):
    args, env, dev = setup(argv, "calib_ddpg", __doc__)
    agent = ddpg.DDPGAgent(agent_config(env.backend.npix, args.M),
                           seed=args.seed, name_prefix=args.prefix,
                           device=dev, collect_diag=diag_from_args(args))
    if args.load:
        agent.load_models()
    return run(env, agent, args.episodes, args.steps, args.use_hint,
               args.prefix, train_obs_from_args(args, "calib_ddpg"), args)


if __name__ == "__main__":
    main()
