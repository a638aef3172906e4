"""Training-internals diagnostics: the ``UpdateDiag`` record (counterpart
of smartcal_tpu/obs/diagnostics.py).

The learn steps (``rl/sac.py``, ``rl/td3.py``, ``rl/ddpg.py``) optionally
return an :class:`UpdateDiag` beside their metrics (``collect_diag=True``):
per-update health scalars computed from tensors the step already holds
(gradients, Adam steps, Q batches, fresh and target parameters), read
before the optimizer step where they describe the old state.  With
``collect_diag=False`` the step is the exact computation without them.

Fields, all () float32 tensors on the step's device:

* ``critic_loss`` / ``actor_loss``: the losses (actor 0 on TD3's delayed
  skip steps);
* ``critic_grad_norm`` / ``actor_grad_norm``: global L2 gradient norms;
* ``critic_update_ratio`` / ``actor_update_ratio``: ||update|| / ||params||;
* ``q_mean`` / ``q_min`` / ``q_max``: the critic's values on the batch;
* ``target_drift``: L2 norm of (critic - target critic);
* ``alpha`` / ``entropy``: SAC temperature and -mean log pi (0 otherwise);
* ``hint_residual``: mean squared actor-hint mismatch under the hint.

torch is imported inside the functions (the callers hold it already), so
importing ``smartcal_tpu_torch.obs`` never imports it.
"""

from typing import Any, Iterator, NamedTuple


class UpdateDiag(NamedTuple):
    """Per-update diagnostics (see the module doc)."""

    critic_loss: Any
    actor_loss: Any
    critic_grad_norm: Any
    actor_grad_norm: Any
    critic_update_ratio: Any
    actor_update_ratio: Any
    q_mean: Any
    q_min: Any
    q_max: Any
    target_drift: Any
    alpha: Any
    entropy: Any
    hint_residual: Any


def _leaves(tree) -> list:
    """The tensors of a tensor, a module, a dict or a nested list/tuple."""
    if hasattr(tree, "parameters") and callable(tree.parameters):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def tree_norm(tree: object):
    """Global L2 norm over every tensor of ``tree`` (0 for an empty one):
    the norm of the per-tensor norms, taken by one multi-tensor kernel
    (``torch._foreach_norm``) rather than a few launches per tensor."""
    import torch

    leaves = [t.detach() for t in _leaves(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    with torch.no_grad():
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(leaves)))


def update_ratio(update_tree: object, param_tree: object,
                 eps: float = 1e-12):
    """||update|| / ||params||: the relative step the optimizer took."""
    return tree_norm(update_tree) / (tree_norm(param_tree) + eps)


def target_drift(params: object, target_params: object):
    """Global L2 norm of (params - target_params)."""
    import torch

    return tree_norm(torch._foreach_sub(
        [a.detach() for a in _leaves(params)],
        [b.detach() for b in _leaves(target_params)]))


def make_diag(device=None, **fields: object) -> UpdateDiag:
    """An :class:`UpdateDiag` with unset fields 0 (agents fill what they
    have), every field a () float32 tensor on ``device`` (default: the
    device of the first tensor given, else the CPU)."""
    import torch

    if device is None:
        device = next((v.device for v in fields.values()
                       if isinstance(v, torch.Tensor)), "cpu")
    vals = {}
    for k in UpdateDiag._fields:
        v = fields.pop(k, 0.0)
        if isinstance(v, torch.Tensor):
            vals[k] = v.detach().to(device=device, dtype=torch.float32)
        else:
            # a fill, not a host-to-device copy: a CUDA graph captures it
            vals[k] = torch.full((), float(v), dtype=torch.float32,
                                 device=device)
    if fields:
        raise TypeError(f"unknown UpdateDiag field(s) {sorted(fields)}")
    return UpdateDiag(**vals)


def zero_diag(device=None) -> UpdateDiag:
    """The no-learn step's diag (every field 0)."""
    return make_diag(device=device)


def stack_diags(diags) -> UpdateDiag:
    """A step-stacked :class:`UpdateDiag` (each field (n,)) of a list of
    per-update ones: the form of a fused episode's updates."""
    import torch

    return UpdateDiag(*(torch.stack([getattr(d, k) for d in diags])
                        for k in UpdateDiag._fields))


def diag_to_host(diag: UpdateDiag) -> dict:
    """One device-to-host transfer of a (possibly step-stacked)
    :class:`UpdateDiag` into ``{field: float | [float, ...]}``; NaN and Inf
    survive here (the RunLog writes them as null, the watchdog checks them
    first)."""
    import torch

    host = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                        .to(diag.critic_loss.device) for v in diag]).cpu()
    return {k: host[i].tolist() for i, k in enumerate(UpdateDiag._fields)}


def diag_steps(host_diag: dict) -> "Iterator[dict]":
    """Iterate a :func:`diag_to_host` dict as per-step dicts (scalar fields
    yield one step)."""
    first = next(iter(host_diag.values()))
    if not isinstance(first, list):
        yield dict(host_diag)
        return
    n = len(first)
    for i in range(n):
        yield {k: (v[i] if isinstance(v, list) else v)
               for k, v in host_diag.items()}
