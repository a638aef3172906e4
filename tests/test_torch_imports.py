"""Import hygiene of the PyTorch port: no module of smartcal_tpu_torch and
not chip_smoke.py imports ``jax`` or anything of the JAX package
``smartcal_tpu`` (the ``smartcal_tpu_torch`` prefix itself is allowed)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "smartcal_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "smartcal_tpu")


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_has_modules():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("cal/creal", "cal/precision", "cal/coords",
                "cal/observation", "cal/coherency", "cal/simulate",
                "cal/consensus", "cal/kernels", "ops/lbfgs", "cal/solver",
                "cal/influence", "cal/imager", "ops/dft_imager",
                "ops/hessian_blocks", "ops/factored_imager",
                "envs/radio", "envs/calib", "rl/networks", "rl/replay",
                "rl/sac", "train/blocks", "train/calib_sac",
                "runtime/atomic", "ops/autodiff", "envs/enet", "rl/td3",
                "rl/ddpg", "train/enet_sac", "train/enet_td3",
                "train/enet_ddpg", "train/enet_eval", "train/calib_td3",
                "train/calib_ddpg", "cal/shapelets", "envs/demixing",
                "envs/demixing_fuzzy", "models/fuzzy", "train/demix_sac",
                "train/demix_td3", "train/demix_fuzzy_sac", "obs/console",
                "obs/tracectx", "obs/runlog", "obs/spans", "obs/registry",
                "obs/diagnostics", "obs/watchdog", "utils/metrics",
                "runtime/checkpoint", "runtime/recovery", "runtime/faults",
                "runtime/backoff", "native/__init__", "cal/skyio",
                "cal/fits_io", "cal/ms_io", "cal/dataset",
                "models/regressor", "models/tsk", "models/transformer",
                "train/supervised", "train/model_influence",
                "train/evaluate", "train/evaluate_models", "train/plots",
                "obs/baselines", "obs/regress", "obs/costs",
                "rl/replay_native", "tools/__init__", "tools/perf_gate",
                "ops/enet_lbfgs", "ops/sym_eigvals",
                "prng", "rl/replay_sharded", "rl/sac_discrete",
                "runtime/ipc", "runtime/supervisor", "parallel/__init__",
                "parallel/mesh", "parallel/multihost", "parallel/trainer",
                "parallel/learner", "parallel/demix_learner",
                "obs/slo", "obs/flightrec", "obs/collect",
                "serve/__init__", "serve/router", "serve/export",
                "serve/server", "serve/loadgen", "serve/fleet",
                "serve/lifecycle", "tools/serve_calib",
                "tools/serve_fleet", "tools/serve_learn"):
        assert f"smartcal_tpu_torch/{mod}.py" in names, mod


def test_new_modules_import_without_jax():
    """The runtime, distributed-training and serving slices' new modules
    import in a process that has no JAX: nothing of them reaches for it,
    directly or through another module."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import smartcal_tpu_torch.obs.costs, "
            "smartcal_tpu_torch.rl.replay_native, "
            "smartcal_tpu_torch.tools.perf_gate, "
            "smartcal_tpu_torch.cal.solver, smartcal_tpu_torch.envs.radio, "
            "smartcal_tpu_torch.train.blocks, "
            "smartcal_tpu_torch.parallel.learner, "
            "smartcal_tpu_torch.parallel.demix_learner, "
            "smartcal_tpu_torch.rl.replay_sharded, "
            "smartcal_tpu_torch.rl.sac_discrete, "
            "smartcal_tpu_torch.runtime.supervisor, "
            "smartcal_tpu_torch.obs.slo, smartcal_tpu_torch.obs.flightrec, "
            "smartcal_tpu_torch.obs.collect, "
            "smartcal_tpu_torch.serve.router, "
            "smartcal_tpu_torch.serve.export, "
            "smartcal_tpu_torch.serve.server, "
            "smartcal_tpu_torch.serve.loadgen, "
            "smartcal_tpu_torch.serve.fleet, "
            "smartcal_tpu_torch.serve.lifecycle, "
            "smartcal_tpu_torch.tools.serve_calib, "
            "smartcal_tpu_torch.tools.serve_fleet, "
            "smartcal_tpu_torch.tools.serve_learn\n"
            "from smartcal_tpu_torch.serve import CalibServer, FleetRouter, "
            "ServingLearner\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'smartcal_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=300)


def test_precision_has_the_bf16_surface():
    """``cal/precision`` carries the whole policy (the bf16 rows too), as
    its own code: every name the JAX module defines."""
    path = os.path.join(ROOT, "smartcal_tpu_torch", "cal", "precision.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    names |= {t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)}
    assert {"POLICIES", "F32", "KERNEL_DTYPES", "check",
            "contraction_dtype", "dtype_name"} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_forbidden_matches_prefix_correctly():
    assert _forbidden("smartcal_tpu.cal.solver")
    assert _forbidden("jax.numpy")
    assert not _forbidden("smartcal_tpu_torch.cal.solver")
    assert not _forbidden("torch")
