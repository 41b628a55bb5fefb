"""Carry weights between the JAX package's flax parameter tree and the
port's ``state_dict``.

The port's submodules carry the flax module names, so a flax leaf at
``encoder/gcn_0/fc1/kernel`` becomes ``encoder.gcn_0.fc1.weight``. Leaf
names map as follows: a Dense ``kernel`` (in, out) becomes a Linear
``weight`` (out, in), transposed; an Embed ``embedding`` and a LayerNorm
``scale`` become ``weight``; ``bias`` stays ``bias``. The copy head's score
kernel (D, 1) becomes the Linear(D, 1) weight (1, D). The typed-edge gains
are a top-level leaf, ``edge_gain``, under the same name on both sides.
Both directions work
on nested dicts of numpy arrays on the flax side. ``adam_state_from_optax``
carries optax Adam moments the same way into a ``torch.optim.Adam``
state_dict, so a JAX train state continues in the port.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _flatten(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def params_from_flax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``params`` tree (nested dict of arrays) -> port state_dict."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, dtype=np.float32)
        *mods, leaf_name = path
        if leaf_name == "kernel":
            name, arr = "weight", arr.T
        elif leaf_name in ("embedding", "scale"):
            name = "weight"
        elif leaf_name == "bias" or path == ("edge_gain",):
            name = leaf_name
        else:
            raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)}")
        out[".".join(mods + [name])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def _flax_leaf_name(module: str, tensor: torch.Tensor) -> str:
    if module.endswith("embed"):
        return "embedding"
    if tensor.dim() == 1:
        return "scale"        # LayerNorm weight
    return "kernel"


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Port state_dict -> flax ``params`` tree of numpy arrays; the
    inverse of :func:`params_from_flax`."""
    tree: Dict = {}
    for key, tensor in state_dict.items():
        *mods, name = key.split(".")
        arr = tensor.detach().cpu().numpy()
        if name == "weight":
            leaf = _flax_leaf_name(mods[-1], tensor)
            if leaf == "kernel":
                arr = arr.T
        elif name == "bias" or key == "edge_gain":
            leaf = name
        else:
            raise KeyError(f"no flax counterpart for {key}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def adam_state_from_optax(mu_tree: Mapping, nu_tree: Mapping, count,
                          model: torch.nn.Module, *, lr: float = 1e-4
                          ) -> Dict:
    """optax Adam moments -> a ``torch.optim.Adam`` state_dict for
    ``model``'s parameters. ``mu_tree`` and ``nu_tree`` are flax trees of
    numpy arrays in the ``params`` layout (``ScaleByAdamState.mu`` /
    ``.nu``), ``count`` its step count; they map by name through
    :func:`params_from_flax`, so a Dense kernel's moments are transposed
    as the kernel is. ``lr`` is the optimizer's learning rate (the
    state_dict carries it; betas and eps are the shared defaults). Reading
    the orbax checkpoint that holds the trees is the caller's job."""
    mu, nu = params_from_flax(mu_tree), params_from_flax(nu_tree)
    names = [name for name, _ in model.named_parameters()]
    if set(mu) != set(names) or set(nu) != set(names):
        raise KeyError(f"moments cover {sorted(set(mu) ^ set(names))} "
                       f"differently from the model's parameters")
    template = torch.optim.Adam(model.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8).state_dict()
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    template["state"] = {
        i: {"step": step.clone(), "exp_avg": mu[name],
            "exp_avg_sq": nu[name]}
        for i, name in enumerate(names)}
    return template
