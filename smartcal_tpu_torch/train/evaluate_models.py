"""Lockstep agent comparison on the demixing env (counterpart of
smartcal_tpu/train/evaluate_models.py; reference
``demixing_rl/evaluate_models.py:32-86``): three SAC agents (trained
without hint, trained with hint, untrained) step the SAME env episodes;
per episode the best-reward action of each is reported, plus the reward
of the exhaustive-AIC hint itself.

Usage:
    python -m smartcal_tpu_torch.train.evaluate_models --games 10
        [--nohint PREFIX] [--withhint PREFIX] [--small] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from smartcal_tpu_torch import obs, resolve_device
from smartcal_tpu_torch.envs.demixing import DemixingEnv
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.rl import sac
from smartcal_tpu_torch.rl.networks import flatten_obs


def evaluate(env: DemixingEnv, agents: dict, n_steps: int, n_games: int,
             quiet=False):
    """Returns {name: [best reward per episode]} plus 'hint' rewards."""
    results = {name: [] for name in agents}
    results["hint"] = []
    for cn in range(n_games):
        obs0 = env.reset()
        flats = {name: flatten_obs(obs0) for name in agents}
        best = {name: -np.inf for name in agents}
        hint = None
        for ci in range(n_steps):
            for name, agent in agents.items():
                action = np.asarray(
                    agent.choose_action(flats[name])).squeeze()
                obs_, reward, done, hint, info = env.step(action)
                flats[name] = flatten_obs(obs_)
                best[name] = max(best[name], reward)
                obs.echo(f"Iter {cn}:{ci} {name} reward {reward:.3f}",
                         quiet=quiet, event="eval_step", game=cn,
                         step=ci, agent=name, reward=float(reward))
        for name in agents:
            results[name].append(best[name])
        _, reward_hint, *_ = env.step(hint)
        results["hint"].append(reward_hint)
        obs.echo(f"Episode {cn}: rewards "
                 + " ".join(f"{n}={results[n][-1]:.3f}" for n in results),
                 quiet=quiet, event="eval_episode", game=cn)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--games", type=int, default=10)
    p.add_argument("--K", type=int, default=6)
    p.add_argument("--nohint", type=str, default="")
    p.add_argument("--withhint", type=str, default="")
    p.add_argument("--small", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of env and agents (cuda, or cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.small:
        backend = RadioBackend(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                               admm_iters=30, lbfgs_iters=3, init_iters=5,
                               npix=32, device=dev)
    else:
        backend = RadioBackend(admm_iters=30, device=dev)
    env = DemixingEnv(K=args.K, provide_hint=True, backend=backend,
                      device=dev)
    npix = backend.npix
    obs_dim = npix * npix + 3 * args.K + 2

    def make_agent(prefix, use_hint):
        cfg = sac.SACConfig(obs_dim=obs_dim, n_actions=args.K,
                            batch_size=256, mem_size=4096, alpha=0.03,
                            use_hint=use_hint, img_shape=(npix, npix))
        a = sac.SACAgent(cfg, name_prefix=prefix, device=dev)
        if prefix and not a.load_models():
            # an evaluation of a fresh random agent under a trained name
            # would be silently misleading: fail loudly instead
            raise FileNotFoundError(
                f"no loadable checkpoint for prefix {prefix!r}")
        return a

    agents = {"nohint": make_agent(args.nohint, False),
              "withhint": make_agent(args.withhint, True),
              "untrained": make_agent("", False)}
    results = evaluate(env, agents, n_steps=args.K, n_games=args.games)
    for name, vals in results.items():
        obs.echo(f"{name}: mean best reward {np.mean(vals):.4f}",
                 event="eval_summary", agent=name,
                 mean_best_reward=float(np.mean(vals)))
    return results


if __name__ == "__main__":
    main()
