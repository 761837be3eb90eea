"""Mixed-precision compute policy (port of infgen_tpu/ops/precision.py).

Master parameters stay float32 unless `param_dtype` says otherwise
(`cast_params_for_compute`). Under a bfloat16 policy, every matmul of the
trunk casts its operands to bf16 explicitly (no `torch.autocast`) and
accumulates in fp32; LayerNorm statistics, softmax, sampling and heads stay
fp32 (model/layers.py).
"""

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": None,
    "f32": None,
    None: None,
}


def compute_dtype_of(name):
    """Config string -> a module compute dtype (None = float32)."""
    return _DTYPES[name]


def cast_params_for_compute(module: torch.nn.Module, dtype_name):
    """Store every floating parameter of `module` in the dtype that
    `dtype_name` names (`param_dtype`), in place; None / "float32" leave
    it. The parameters stay the same objects (an optimizer built on them
    keeps them); its state must be made anew. A module computes with such
    weights as the JAX package's promotion does: a float32 policy takes
    bf16 weights times f32 inputs in f32 (model/layers.py). Returns the
    module."""
    dt = compute_dtype_of(dtype_name) if isinstance(dtype_name, str) \
        else dtype_name
    if dt is None:
        return module
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dt)
    return module
