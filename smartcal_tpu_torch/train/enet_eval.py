"""Evaluate a trained elastic-net SAC agent against grid search
(counterpart of smartcal_tpu/train/enet_eval.py; reference
``elasticnet/enet_eval.py:85-112``).

The agent picks the regularisation by deterministic actions over
fixed-noise (``keepnoise``) steps; grid search (the env's hint: the 5x5
lambda grid with 2-fold cross-validation) picks its own; both solutions
are compared to the ground truth by relative L1 error.

    python -m smartcal_tpu_torch.train.enet_eval --games 2 \
        --agent sac_state.pkl [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np
import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs import enet
from smartcal_tpu_torch.rl import sac
from smartcal_tpu_torch.runtime.atomic import strict_pickle_load


def solve_enet(A, y, lam1, lam2, M):
    """Plain elastic-net solve at the given regularisation (SKEnet.fit):
    ``||y - Ax||^2 + lam2 ||x||^2 + lam1 ||x||_1`` by 200 L-BFGS
    iterations from 0."""
    rho = torch.stack([torch.as_tensor(lam2), torch.as_tensor(lam1)])
    return enet._solve(enet.EnetConfig(M=M, N=y.shape[0]), A, y,
                       rho.to(A)).x[0]


def evaluate(agent_path: str = "sac_state.pkl", games: int = 2,
             steps: int = 4, M: int = 20, N: int = 20, seed: int = 0,
             device="cuda", quiet: bool = False):
    """``games`` rows of the RL and grid-search rho and relative errors."""
    dev = resolve_device(device)
    env_cfg = enet.EnetConfig(M=M, N=N)
    agent_cfg = sac.SACConfig(obs_dim=env_cfg.obs_dim, n_actions=2)
    agent_state = sac.SACState.from_host(
        agent_cfg, strict_pickle_load(agent_path), dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    results = []
    for i in range(games):
        st, obs = enet.reset(env_cfg, *enet.reset_draws(env_cfg, generator,
                                                        dev))
        st = enet.draw_noise(env_cfg, st, torch.randn(
            N, generator=generator, device=dev))
        rho = None
        for _ in range(steps):                  # RL rollout on fixed noise
            action = sac.choose_action(agent_cfg, agent_state, obs,
                                       deterministic=True)
            rho, _ = enet.action_to_rho(action)
            st, obs, _, _ = enet.step(env_cfg, st, action, None,
                                      keepnoise=True)
        # grid search on the same data; hint[0] = lambda1 (L1), hint[1] =
        # lambda2 (L2) in the SKEnet objective (enetenv.py:237-239,275-280)
        lam_grid, _ = enet.action_to_rho(enet.get_hint(env_cfg, st))
        x_grid = solve_enet(st.A, st.y, lam_grid[0], lam_grid[1], M)
        x0 = st.x0.cpu().numpy()

        def rel(x):
            return (np.linalg.norm(x0 - x.cpu().numpy(), 1)
                    / np.linalg.norm(x0, 1))

        row = {"game": i, "rl_rho": rho.cpu().numpy().tolist(),
               "grid_rho": lam_grid.cpu().numpy().tolist(),
               "rl_rel_err": float(rel(st.x)),
               "grid_rel_err": float(rel(x_grid))}
        results.append(row)
        if not quiet:
            sys.stderr.write(
                f"{i} RL {row['rl_rho'][0]:.4f},{row['rl_rho'][1]:.4f} "
                f"GR {row['grid_rho'][0]:.4f},{row['grid_rho'][1]:.4f}\n"
                f"RL {row['rl_rel_err']:.4f} GR {row['grid_rel_err']:.4f}\n")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--agent", default="sac_state.pkl")
    p.add_argument("--games", default=2, type=int)
    p.add_argument("--steps", default=4, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of env and agent (cuda, or cpu when "
                        "asked for)")
    args = p.parse_args(argv)
    return evaluate(agent_path=args.agent, games=args.games,
                    steps=args.steps, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
