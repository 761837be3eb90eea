"""Export of the closed-loop rollout as a serialized artifact (port of
infgen_tpu/rollout/export.py).

Production serving wants the simulator as a deployable artifact, not a
Python session over the model code: `torch.export` traces the rollout's
three tensor programs (rollout/closed_loop.py: prologue, token step,
epilogue; static shapes, which the fixed-capacity design guarantees), and a
server loads and calls them without the model or tokenizer code and
without a re-trace. The reference has no equivalent (its inference is a
Python loop over torch modules, agent_decoder.py:1605-2389).

The artifact is keyed by capacity (A, P), like the serving buckets
(rollout/serving.py), and holds one lane (one scenario), as the JAX
package's does. Parameters stay an argument: every program takes the
model's state dict, so one artifact serves any checkpoint of the same
architecture. It is exported with `insertion_fixed_trip` (a step reads
nothing on the host) and holds six programs: the prologue, the first token
step (no insertion), a token step's three parts (insertion_open, one
insertion_iter, which the loader's loop calls insert_limit times, and
close_step: the inserts applied, motion, heads and de-tokenization) and the
epilogue. The insertion loop is a program of its own because torch.export
unrolls a Python loop: ten copies of the iteration made the flagship's
step a graph of about 60,000 nodes, minutes to trace, save and load. No
program reads the host or branches on a step's column, a 0-d tensor. The
hand-written kernels appear in them as the registered ops `infgen::*`
(ops/*.py), which loading registers by importing the ops modules. The
random draws enter the step programs as tensors (`torch.export` cannot take
a `torch.Generator` as an input): the loader's step loop draws them from
the caller's generator exactly as the direct fixed-trip rollout does
(ops/sampling.step_variates), so the two give the same trajectories bit
for bit.

Blob layout: MAGIC, the header's length (8 bytes, little-endian), the
header (JSON: capacity, steps, device, dtype policy, kernel flags, variate
counts, the state dict's names, shapes and dtypes, each program's length),
then each program's `torch.export.save` payload in the header's order.
"""

import io
import json
import os
import struct
from typing import Optional

import torch
import torch.utils._pytree as pytree

from infgen_torch.data.scenario import (AgentData, MapData, ModelInputs,
                                        Scenario, TokenizedAgents, tree_map)
from infgen_torch.ops import column_kernel  # noqa: F401 (registers its op)
from infgen_torch.ops import fused_block  # noqa: F401
from infgen_torch.ops import pallas_attention  # noqa: F401
from infgen_torch.ops import refine_kernel  # noqa: F401
from infgen_torch.ops import seed_kernel  # noqa: F401
from infgen_torch.ops.sampling import step_variates
from infgen_torch.rollout.carry import RolloutCarry

MAGIC = b"INFGEN-ROLLOUT-PT2\n"
KERNEL_FLAGS = ("use_seed_kernel", "use_seed_kernel_full",
                "use_refine_kernel", "use_column_kernel", "use_fused_block",
                "use_pallas_attention")


def _register_pytrees():
    """Register the port's NamedTuples that cross a program's boundary for
    serialization (idempotent: one already registered is left as it is)."""
    for cls in (AgentData, MapData, Scenario, TokenizedAgents, ModelInputs,
                RolloutCarry):
        if cls in pytree.SUPPORTED_SERIALIZED_TYPES:
            continue
        pytree._register_namedtuple(
            cls, serialized_type_name=f"infgen_torch.{cls.__name__}")


_register_pytrees()


class _Program(torch.nn.Module):
    """One of the rollout's programs over the model: forward(params, *args)
    runs `fn(*args)` with the model's parameters and buffers taken from the
    state dict `params`. The model is not a submodule, so the exported
    program holds no weights of its own."""

    def __init__(self, model, fn):
        super().__init__()
        self.fn = fn
        object.__setattr__(self, "model", model)

    def forward(self, params, *args):
        from torch.nn.utils.stateless import _reparametrize_module
        with _reparametrize_module(self.model, params):
            return self.fn(*args)


def export_rollout(cfg, attr, motion_tok, map_vocab, scenario, inputs,
                   generator, params,
                   num_recurrent_steps: Optional[int] = None,
                   force_insert: bool = False) -> bytes:
    """Serialize the rollout programs for `cfg`'s (A, P) capacity.

    `scenario` / `inputs` (one scenario, no lane axis, on the device the
    artifact is for: data.scenario.to_device, data.features
    .build_model_inputs), `generator` (a torch.Generator on that device;
    nothing is drawn from it) and `params` (a state dict of the port's
    InfGenModel) are templates: any with the right shapes and dtypes work.
    The programs run with `insertion_fixed_trip` on, whatever `cfg` says;
    force_insert as make_rollout_fn's.
    """
    from infgen_torch.model.infgen import InfGenModel
    from infgen_torch.rollout.closed_loop import make_rollout_fn

    device = inputs.slot_mask.device
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"template on {device}")
    cfg = cfg.replace(insertion_fixed_trip=True)
    model = InfGenModel(cfg, attr.grid, attr.grid_size, attr.angle_size)
    model = model.to(device).eval()
    model.load_state_dict(params, strict=True)
    roll = make_rollout_fn(model, cfg, attr, motion_tok, map_vocab,
                           num_recurrent_steps=num_recurrent_steps,
                           force_insert=force_insert)
    unflat = roll.unflat_ctx
    programs = dict(
        prologue=lambda scen, inp: (lambda c, x: (c, roll.flat_ctx(x)))(
            *roll.prologue(scen, inp)),
        step0=lambda carry, flat, col, u_mot: roll.step(
            carry, unflat(flat), col, False, None, u_mot),
        step_open=lambda carry, flat, col, u0: roll.insertion_open(
            carry, unflat(flat), col, u0),
        step_iter=lambda ins, flat, loop, u: roll.insertion_iter(
            ins, unflat(flat), loop, u),
        step_close=lambda carry, flat, ins, loop, col, u_mot:
            roll.close_step(carry, unflat(flat), ins, loop, col, u_mot),
        epilogue=lambda carry, outs, scen, inp, flat: roll.epilogue(
            carry, outs, scen, inp, unflat(flat)))
    n_ins, n_cand, n_mot = roll.variate_counts(True)
    insertion = not cfg.disable_insertion and roll.n_steps > 1

    # templates: each program's inputs as the loader's loop gives them
    scen, inp = (tree_map(lambda x: x[None], t) for t in (scenario, inputs))
    u_ins, u_mot = step_variates(
        [torch.Generator(device=device).manual_seed(0)], device, n_ins,
        n_cand, n_mot)
    u = (lambda j: None) if u_ins is None else \
        (lambda j: u_ins[:, j].contiguous())
    col = torch.tensor(1, device=device)
    blobs = {}
    with torch.no_grad():
        def trace(name, *args):
            blobs[name] = _save(_Program(model, programs[name]),
                                (params, *args))
            return programs[name](*args)

        carry, flat = trace("prologue", scen, inp)
        carry, out = trace("step0", carry, flat, col, u_mot)
        if insertion:
            col = col + 1
            loop, ins = trace("step_open", carry, flat, col, u(0))
            loop = trace("step_iter", ins, flat, loop, u(1))
            carry, out = trace("step_close", carry, flat, ins, loop, col,
                               u_mot)
        outs = {k: torch.stack([v] * roll.n_steps, 1) for k, v in out.items()}
        trace("epilogue", carry, outs, scen, inp, flat)

    header = dict(
        format=1, max_agents=cfg.max_agents,
        max_map_tokens=cfg.max_map_tokens, steps=roll.n_steps,
        frames=num_recurrent_steps or cfg.num_recurrent_steps_val,
        insertion=insertion, insert_limit=cfg.insert_limit,
        force_insert=force_insert, device=device.type,
        compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype,
        kernels={f: bool(getattr(cfg, f)) for f in KERNEL_FLAGS},
        variates=dict(n_insert=n_ins, n_cand=n_cand, n_motion=n_mot),
        params={k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                for k, v in params.items()},
        programs={k: len(v) for k, v in blobs.items()})
    head = json.dumps(header).encode()
    return b"".join([MAGIC, struct.pack("<Q", len(head)), head,
                     *blobs.values()])


def _save(program, args) -> bytes:
    """One program traced by torch.export and serialized. Every template
    tensor is copied first: torch.export takes two arguments that are one
    tensor for one input, and the rollout's state has such pairs (the
    initial slots and the carry's, a scenario field and the carry's) that
    part later. Before saving, the example inputs (the template weights
    and scenario), the graph's dtype assertions and dead nodes, and each
    node's source records go: they change no result and would make the
    payload and its load several times slower."""
    args = pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, args)
    ep = torch.export.export(program, args, strict=False)
    ep.example_inputs = None
    graph = ep.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    graph.eliminate_dead_code()
    for node in graph.nodes:
        for key in ("stack_trace", "nn_module_stack", "source_fn_stack",
                    "torch_fn", "from_node"):
            node.meta.pop(key, None)
    ep.graph_module.recompile()
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_rollout_artifact(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)


def read_header(blob: bytes) -> dict:
    """The header of an artifact's bytes."""
    if not blob.startswith(MAGIC):
        raise ValueError("not an exported rollout artifact")
    n = struct.unpack_from("<Q", blob, len(MAGIC))[0]
    start = len(MAGIC) + 8
    return json.loads(blob[start:start + n])


def load_rollout_artifact(path_or_blob):
    """Load an exported rollout; returns `fn(params, scenario, inputs,
    generator) -> dict`: the direct fixed-trip rollout's outputs
    (closed_loop.make_rollout_fn) for one scenario (no lane axis) with the
    state dict `params` (names, shapes and dtypes as exported, on the
    artifact's device: anything else raises), the variates drawn from
    `generator`. `fn.header` is the artifact's header, `fn.programs` its
    ExportedPrograms by name. An artifact for `cuda` raises on a host
    without CUDA."""
    blob = path_or_blob
    if isinstance(path_or_blob, (str, os.PathLike)):
        with open(path_or_blob, "rb") as f:
            blob = f.read()
    blob = bytes(blob)
    header = read_header(blob)
    device = torch.device(header["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this rollout artifact was exported for cuda, "
                           "and CUDA is not available here")
    off = len(MAGIC) + 8 + struct.unpack_from("<Q", blob, len(MAGIC))[0]
    programs = {}
    for name, n in header["programs"].items():
        programs[name] = torch.export.load(io.BytesIO(blob[off:off + n]))
        off += n
    mods = {name: ep.module() for name, ep in programs.items()}
    spec = header["params"]
    var = header["variates"]
    cols = torch.arange(header["steps"] + 1, device=device)

    @torch.no_grad()
    def fn(params, scenario, inputs, generator):
        _check_params(params, spec, device)
        scen, inp = (tree_map(lambda x: x[None], t)
                     for t in (scenario, inputs))
        carry, flat = mods["prologue"](params, scen, inp)
        outs = []
        for t in range(header["steps"]):
            insert = header["insertion"] and t > 0
            u_ins, u_mot = step_variates(
                [generator], device, var["n_insert"] if insert else 0,
                var["n_cand"], var["n_motion"])
            col = cols[t + 1]
            if not insert:
                carry, out = mods["step0"](params, carry, flat, col, u_mot)
            else:
                u = (lambda j: None) if u_ins is None else \
                    (lambda j: u_ins[:, j].contiguous())
                loop, ins = mods["step_open"](params, carry, flat, col, u(0))
                for j in range(1, header["insert_limit"] + 1):
                    loop = mods["step_iter"](params, ins, flat, loop, u(j))
                carry, out = mods["step_close"](params, carry, flat, ins,
                                                loop, col, u_mot)
            outs.append(out)
        outs = {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}
        res = mods["epilogue"](params, carry, outs, scen, inp, flat)
        return {k: v[0] for k, v in res.items()}

    fn.header, fn.programs = header, programs
    return fn


def _check_params(params, spec, device):
    """Raise unless `params` holds exactly the exported state dict's names,
    each with its shape and dtype, on the artifact's device."""
    missing = sorted(set(spec) - set(params))
    extra = sorted(set(params) - set(spec))
    if missing or extra:
        raise KeyError(f"state dict does not match the artifact: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    for k, (shape, dtype) in spec.items():
        v = params[k]
        if list(v.shape) != shape or str(v.dtype) != f"torch.{dtype}":
            raise ValueError(f"{k}: {tuple(v.shape)} {v.dtype}, the artifact "
                             f"takes {tuple(shape)} torch.{dtype}")
        if v.device.type != device.type:
            raise ValueError(f"{k} is on {v.device}, the artifact runs on "
                             f"{device}")
