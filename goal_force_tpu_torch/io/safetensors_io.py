"""Weight files (safetensors, torch ``.pth``) and the goal-force checkpoints.

Port of ``goal_force_tpu/io/safetensors_io.py``. The safetensors reader and writer are
the port's own, so the port needs no ``safetensors`` package: an 8-byte little-endian
header length, a JSON header naming each tensor's dtype, shape and byte range, then the
raw little-endian bytes, tensors back to back. F32, BF16, I64 and I32 are
supported; BF16 is stored as it is (the JAX package's numpy backend cannot write it).
``load_safetensors`` takes one file, a glob or a list of shards (the A14B experts come
as six shards each); ``load_torch_pth`` reads a torch pickle checkpoint
(``Wan2.1_VAE.pth``, the umt5 encoder) with its tensors in their own dtypes.

Checkpoints:
  - ``step-K.safetensors``: the ControlNet alone in the reference's format, its
    state-dict names under ``pipe.controlnet.``, float32 (what the JAX package exports);
  - with LoRA training, ``step-K.safetensors`` holds the adapters as PEFT keys
    (``lora.py::lora_to_peft``), plus the ControlNet's keys when it trains jointly;
  - ``state-K.safetensors``: the full training state (parameters, AdamW moments and
    counters, the step) in their own dtypes, for a resume that is bit-identical.
"""

from __future__ import annotations

import glob
import json
import os
import re
import struct
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

_DTYPES = {torch.float32: ("F32", np.float32), torch.bfloat16: ("BF16", np.int16),
           torch.int64: ("I64", np.int64), torch.int32: ("I32", np.int32)}
_BY_NAME = {name: (dt, np_dt) for dt, (name, np_dt) in _DTYPES.items()}

CKPT_PREFIX = "pipe.controlnet."


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write `tensors` (any device; F32, BF16, I64 or I32) to one safetensors file."""
    header, arrays, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach()
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} is not supported (F32, BF16, I64, I32)")
        code, np_dt = _DTYPES[t.dtype]
        arr = t.to("cpu").contiguous()
        arr = (arr.view(torch.int16) if t.dtype == torch.bfloat16 else arr).numpy()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        arrays.append(arr)
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:
            f.write(arr.tobytes())      # little-endian hosts (x86-64, aarch64)


def _read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        start = 8 + n
        size = os.fstat(f.fileno()).st_size - start
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _BY_NAME:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            dtype, np_dt = _BY_NAME[info["dtype"]]
            b, e = info["data_offsets"]
            shape = tuple(info["shape"])
            count = int(np.prod(shape))
            if not 0 <= b <= e <= size or e - b != count * np.dtype(np_dt).itemsize:
                raise ValueError(f"{path}: {name} has a bad byte range {b}..{e}")
            f.seek(start + b)
            t = torch.from_numpy(np.fromfile(f, np_dt, count).reshape(shape))
            out[name] = t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
    return out


def load_safetensors(paths: Union[str, Sequence[str]]) -> Dict[str, torch.Tensor]:
    """Read one file, a glob or a list of shards into one dict of CPU tensors. A glob
    that matches nothing, or a name that two shards both hold, raises."""
    if isinstance(paths, (str, os.PathLike)):
        paths = str(paths)
        expanded = sorted(glob.glob(paths)) if any(c in paths for c in "*?[") else [paths]
        if not expanded:
            raise FileNotFoundError(f"no file matches {paths!r}")
    else:
        expanded = [str(p) for p in paths]
    out: Dict[str, torch.Tensor] = {}
    for p in expanded:
        shard = _read_safetensors(p)
        twice = sorted(set(shard) & set(out))
        if twice:
            raise ValueError(f"{p}: tensors {twice[:5]} are also in an earlier shard")
        out.update(shard)
    return out


def load_torch_pth(path: str) -> Dict[str, torch.Tensor]:
    """A torch pickle checkpoint (``torch.load(weights_only=True)``) as a state dict of
    CPU tensors in their own dtypes, unwrapping the ``model_state`` wrapper the
    reference unwraps for ``Wan2.1_VAE.pth``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state" in sd:
        sd = sd["model_state"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state dict, found {type(sd).__name__}")
    return dict(sd)


# ---------------------------------------------------------------------------
# Goal-force ControlNet checkpoints (reference format)
# ---------------------------------------------------------------------------

def export_goalforce_controlnet(cn: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The ControlNet's state dict under the reference names, float32 on the CPU."""
    return {CKPT_PREFIX + k: v.detach().to("cpu", torch.float32)
            for k, v in cn.state_dict().items()}


def load_goalforce_controlnet(path: str) -> Dict[str, torch.Tensor]:
    """A step-K.safetensors checkpoint as a state dict for ``GoalForceControlNet``."""
    sd = load_safetensors(path)
    return {k[len(CKPT_PREFIX):] if k.startswith(CKPT_PREFIX) else k: v for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Full training state (parameters + optimizer state + step)
# ---------------------------------------------------------------------------

def train_state_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"state-{step}.safetensors")


def param_tensors(params) -> Dict[str, torch.Tensor]:
    """A training state's parameters by name: the ControlNet's state dict, or for LoRA
    training ``lora.<target>.<a|b>`` and ``controlnet.<name>``."""
    if isinstance(params, torch.nn.Module):
        return params.state_dict()
    out = {f"lora.{t}.{k}": v for t, ab in params["lora"].items() for k, v in ab.items()}
    if params.get("controlnet") is not None:
        out.update({f"controlnet.{k}": v for k, v in params["controlnet"].state_dict().items()})
    return out


def _state_tensors(state) -> Dict[str, torch.Tensor]:
    out = {f"params.{k}": v for k, v in param_tensors(state.params).items()}
    out.update({f"opt.{k}": v for k, v in state.opt_state.items()})
    out["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    return out


def save_train_state(state, path: str) -> None:
    """Write a ``TrainState``: ``params.*`` (``param_tensors``), ``opt.*`` (the
    optimizer's tensors: AdamW ``exp_avg``/``exp_avg_sq``, ``count``, and the
    accumulation buffers when gradients are accumulated) and ``step``, each in its own
    dtype."""
    save_safetensors(_state_tensors(state), path)


def load_train_state(path: str, state):
    """Fill ``state`` (built for the same model and optimizer settings) from `path`, in
    place, and return it. A missing, extra or mis-shaped tensor raises: a changed model
    or optimizer cannot silently load a stale state."""
    sd = load_safetensors(path)
    want = _state_tensors(state)
    if set(sd) != set(want):
        missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
        raise KeyError(f"{path}: state mismatch (missing {missing[:5]}, unexpected {extra[:5]})")
    for name, dst in want.items():
        src = sd[name]
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(f"{path}: {name} is {src.dtype} {tuple(src.shape)}, "
                             f"expected {dst.dtype} {tuple(dst.shape)}")
    with torch.no_grad():
        for name, dst in want.items():
            if name != "step":
                dst.copy_(sd[name])
    state.step = int(sd["step"])
    return state


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The step-K.safetensors with the largest K, or None."""
    cands: List[tuple] = []
    for p in glob.glob(os.path.join(ckpt_dir, "step-*.safetensors")):
        m = re.search(r"step-(\d+)\.safetensors$", p)
        if m:
            cands.append((int(m.group(1)), p))
    return max(cands)[1] if cands else None


def checkpoint_step(path: str) -> int:
    m = re.search(r"step-(\d+)\.safetensors$", path)
    return int(m.group(1)) if m else 0
