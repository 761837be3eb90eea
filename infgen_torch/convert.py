"""Weights across the two packages: a flax params tree -> InfGenModel.

`load_flax_params(model, tree)` takes the JAX package's params as a nested
dict of numpy arrays (what `jax.device_get(variables["params"])` returns)
and writes every torch parameter. Names match one to one (model/layers.py):
flax `kernel` [in, out] becomes `weight` [out, in]; LayerNorm `scale`
becomes `weight`; Embed `embedding` becomes `weight`; `w_kr`, `w_vr`,
`b_vr`, `freqs` and `bias` keep name and layout. Every flax leaf must have a
target and every torch parameter must be written, so a tree from any slice
of the JAX package fills the port without a new format.

`to_flax_tree(model)` is the inverse: every parameter (or, with
`grads=True`, its `.grad`, zeros where it has none) back into a flax-shaped
nested dict of numpy arrays, kernels transposed, so that a test compares
the port's gradients and updated weights with the JAX package's leaf by
leaf.

`save_npz` / `load_npz` store such a tree flat ("a/b/c" keys), so a machine
without JAX can take converted weights (`cli.py rollout --params x.npz`).
"""

from typing import Dict

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def flatten_tree(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def torch_name(path: tuple) -> str:
    """Flax leaf path -> torch parameter name."""
    return ".".join(path[:-1] + (_LEAF.get(path[-1], path[-1]),))


@torch.no_grad()
def load_flax_params(model: nn.Module, tree) -> None:
    """Fill every parameter of `model` from the flax tree `tree`."""
    params = dict(model.named_parameters())
    written = set()
    for path, arr in flatten_tree(tree).items():
        name = torch_name(path)
        if name not in params:
            raise KeyError(f"flax leaf {'/'.join(path)} has no torch target "
                           f"({name})")
        val = torch.as_tensor(np.array(arr, dtype=np.float32))
        if path[-1] == "kernel":
            val = val.T
        p = params[name]
        if tuple(val.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax {tuple(val.shape)} vs torch "
                             f"{tuple(p.shape)}")
        p.copy_(val.to(p.device))
        written.add(name)
    missing = sorted(set(params) - written)
    if missing:
        raise KeyError(f"torch parameters not in the flax tree: {missing}")


def to_flax_tree(model: nn.Module, grads: bool = False) -> dict:
    """Every parameter of `model` (its gradient with `grads`) as a flax
    params tree of float32 numpy arrays: Dense `weight` -> `kernel`
    transposed, LayerNorm `weight` -> `scale`, Embed `weight` ->
    `embedding`; the rest keep name and layout."""
    from infgen_torch.model.layers import Dense, Embed, LayerNorm

    leaf_of = {Dense: "kernel", LayerNorm: "scale", Embed: "embedding"}
    tree: dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path)) if path else model
        val = p.grad if grads else p
        val = torch.zeros_like(p) if val is None else val
        arr = val.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf = leaf_of[type(owner)]
            if leaf == "kernel":
                arr = arr.T
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def save_npz(tree, path: str) -> None:
    np.savez(path, **{"/".join(k): v for k, v in flatten_tree(tree).items()})


def load_npz(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
