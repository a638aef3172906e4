"""Demixing recommendation CLI for real observations (counterpart of
smartcal_tpu/train/evaluate.py; reference ``demixing/evaluate.py:51-61``):
given an MS glob pattern and a time duration, featurize the observation
(``cal.dataset.get_info_from_dataset``) and run the trained transformer
classifier to print per-direction demixing recommendations.

The MSs may be real casacore MSs (with python-casacore) or the sct/npz
stores of :func:`cal.ms_io.observation_to_ms_set`: the featurization path
is the same.  Everything runs on ``--device`` (default cuda).

Usage:
  python -m smartcal_tpu_torch.train.evaluate 'L_SB*.MS' 600 --model net.pkl
  python -m smartcal_tpu_torch.train.evaluate --selftest [--device cpu]

Checkpoint format: pickle {"params": {name: numpy array}, "K": int,
"npix": int, "model_dim": int}, written by :func:`save_model` (the
counterpart of the reference's net.model state-dict file).
"""

from __future__ import annotations

import argparse
import glob
import pickle

import numpy as np
import torch

from smartcal_tpu_torch import obs, resolve_device
from smartcal_tpu_torch.cal import dataset
from smartcal_tpu_torch.models.transformer import build_transformer


def save_model(path, params, K=6, npix=64, model_dim=66):
    """Pickle the model's {name: tensor} as host numpy arrays."""
    with open(path, "wb") as fh:
        pickle.dump({"params": {k: v.detach().cpu().numpy()
                                for k, v in params.items()},
                     "K": K, "npix": npix, "model_dim": model_dim}, fh)


def load_model(path, device="cuda"):
    """(model, params, K, npix) of a :func:`save_model` file, the model on
    ``device`` holding the parameters."""
    from smartcal_tpu_torch.runtime.atomic import strict_pickle_load

    dev = resolve_device(device)
    ck = strict_pickle_load(path)
    K, npix = ck["K"], ck["npix"]
    model = build_transformer(K, npix, ck["model_dim"], device=dev)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in ck["params"].items()})
    return model, dict(model.named_parameters()), K, npix


def evaluate_model(x, model):
    """Transformer forward on one feature vector -> (K-1,) probabilities
    (demixing/evaluate.py:21-46)."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(torch.as_tensor(np.asarray(x, np.float32),
                                    device=dev)[None])
    return out[0].cpu().numpy()


def recommend(mslist, timesec, model_path, tdelta=10, sky_path=None,
              cluster_path=None, workdir=".", seed=0, device="cuda",
              stage_seconds=None):
    """Featurize the MSs and run the model: (K-1,) probabilities.
    ``seed`` picks the random time window (and interior sub-bands) of
    extract_dataset; ``stage_seconds`` collects the featurization's
    stages and "forward"."""
    model, _, K, npix = load_model(model_path, device)
    x = dataset.get_info_from_dataset(
        mslist, timesec, Ninf=npix, K=K, tdelta=tdelta, sky_path=sky_path,
        cluster_path=cluster_path, workdir=workdir,
        rng=np.random.default_rng(seed), device=device,
        stage_seconds=stage_seconds)
    with dataset.timed(stage_seconds, "forward", device):
        return evaluate_model(x, model)


def _selftest(args):
    """End-to-end demo without external data: simulate an observation,
    write it through the MS edge, train a tiny transformer on synthetic
    features, then run the real-data path on the MS files."""
    import tempfile

    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.cal import ms_io
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.train import supervised

    dev = resolve_device(args.device)
    backend = RadioBackend(n_stations=args.stations, n_times=args.times,
                           tdelta=args.tdelta, npix=args.npix,
                           admm_iters=4, lbfgs_iters=4, init_iters=8,
                           device=dev)
    K = args.K
    with tempfile.TemporaryDirectory() as tmp:
        ep, _ = backend.new_demixing_episode(prng.PRNGKey(0), K)
        mslist = ms_io.observation_to_ms_set(tmp, ep.obs, ep.V)
        buf = supervised.make_transformer_dataset(
            n_iter=2, K=K, backend=backend, seed=0, device=dev)
        params, _ = supervised.train_transformer(buf, K=K, epochs=20,
                                                 model_dim=12, device=dev)
        save_model(f"{tmp}/net.pkl", params, K=K, npix=args.npix,
                   model_dim=12)
        probs = recommend(mslist, timesec=args.times * 0.8,
                          model_path=f"{tmp}/net.pkl", tdelta=args.tdelta,
                          workdir=tmp, device=dev)
    obs.echo(f"selftest recommendation: {probs}", event="recommendation")
    return probs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("pattern", nargs="?", help="MS glob pattern")
    p.add_argument("timesec", nargs="?", type=float,
                   help="time duration to sample (seconds)")
    p.add_argument("--model", default="net.pkl")
    p.add_argument("--seed", default=0, type=int,
                   help="random time-window / sub-band draw")
    p.add_argument("--tdelta", default=10, type=int)
    p.add_argument("--sky", default=None, help="sky model text file")
    p.add_argument("--cluster", default=None, help="cluster text file")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--stations", default=8, type=int)
    p.add_argument("--times", default=20, type=int)
    p.add_argument("--npix", default=16, type=int)
    p.add_argument("--K", default=6, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    args = p.parse_args(argv)

    if args.selftest:
        return _selftest(args)
    if not args.pattern or args.timesec is None:
        p.error("usage: evaluate.py 'MS*pattern' time(seconds) "
                "[--model net.pkl]  (or --selftest)")
    mslist = glob.glob(args.pattern)
    if not mslist:
        p.error(f"no MS matched {args.pattern!r}")
    probs = recommend(mslist, args.timesec, args.model, tdelta=args.tdelta,
                      sky_path=args.sky, cluster_path=args.cluster,
                      seed=args.seed, device=args.device)
    obs.echo("Demixing recommendation (probability per outlier direction):",
             event=None)
    for i, v in enumerate(probs):
        obs.echo(f"  direction {i}: {v:.4f}  ->  "
                 f"{'DEMIX' if v > 0.5 else 'skip'}",
                 event="recommendation", direction=i, prob=float(v))
    return probs


if __name__ == "__main__":
    main()
