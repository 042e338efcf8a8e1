"""Host staging for the off-duty expert pair.

Port of ``goal_force_tpu/parallel/host_staging.py``. A pair is ``{"dit": module,
"controlnet": module}``; staging moves every parameter **and buffer** of its modules (the
W8A8 packs are buffers) in place, so the module objects, and the pipeline's
``models`` dict that holds them, stay the same. "Host" is pinned CPU memory when the
device is CUDA, and plain CPU memory when the caller put the pipeline on the CPU.

``ExpertStager`` keeps the active pair on the device and the standby pair on the host.
JAX's ``swap()`` places the standby pair on the device before it stages the active pair
out, which at full A14B depth in bf16 would hold both pairs (2 x 33.7 GiB) and T5 on an
80 GB card at once. Here the swap goes tensor by tensor: each standby tensor is copied
to the device, then the active tensor that takes its slot is copied into the host
buffer it came from. The device never holds more than one pair and one tensor, and the
host buffers, pinned once, serve every swap. Both orders compute the same thing.

Pinned buffers are carved from chunks of a power-of-two size: PyTorch's caching host
allocator rounds each pinned allocation up to a power of two, which would add 81 % to
each 141.6 MB A14B FFN weight and about half to a whole expert.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

Pair = Dict[str, nn.Module]


def _slots(pair: Pair) -> Iterator[Tuple[nn.Module, str, str]]:
    """(owning module, "p" or "b", name) of every parameter and buffer, in a fixed
    order: the pair's keys sorted, then each module's submodules as ``modules()``
    walks them."""
    for key in sorted(pair):
        for mod in pair[key].modules():
            for name, t in mod._parameters.items():
                if t is not None:
                    yield mod, "p", name
            for name, t in mod._buffers.items():
                if t is not None:
                    yield mod, "b", name


def _get(mod: nn.Module, kind: str, name: str) -> torch.Tensor:
    """The tensor in the slot (a parameter's ``.data``, so the Parameter object stays)."""
    return mod._parameters[name].data if kind == "p" else mod._buffers[name]


def _set(mod: nn.Module, kind: str, name: str, t: torch.Tensor) -> None:
    if kind == "p":
        mod._parameters[name].data = t
    else:
        mod._buffers[name] = t


_CHUNK = 1 << 30      # bytes of the largest pinned chunk
_ALIGN = 256          # bytes between tensors carved from one chunk


def _host_like(tensors, pin: bool):
    """Empty CPU tensors of the shapes and dtypes of `tensors`, pinned if `pin`."""
    if not pin:
        return [torch.empty(t.shape, dtype=t.dtype, device="cpu") for t in tensors]
    sizes = [-(-t.numel() * t.element_size() // _ALIGN) * _ALIGN for t in tensors]
    left = sum(n for n in sizes if n <= _CHUNK)
    out, chunk, used = [], None, 0
    for t, n in zip(tensors, sizes):
        if n > _CHUNK:
            out.append(torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True))
            continue
        if chunk is None or used + n > chunk.numel():
            size = min(_CHUNK, 1 << (left - 1).bit_length())
            chunk, used = torch.empty(size, dtype=torch.uint8, device="cpu", pin_memory=True), 0
        nbytes = t.numel() * t.element_size()
        out.append(chunk[used:used + nbytes].view(t.dtype).view(t.shape))
        used += n
        left -= n
    return out


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def stage_to_host(pair: Pair, pin_memory: Optional[bool] = None) -> Pair:
    """Move the pair's tensors to host memory, pinned when `pin_memory` (by default
    where CUDA is available); tensors already there stay as they are. Returns the
    pair."""
    pin = torch.cuda.is_available() if pin_memory is None else pin_memory
    moves = []
    for mod, kind, name in _slots(pair):
        t = _get(mod, kind, name)
        if t.device.type != "cpu" or (pin and not t.is_pinned()):
            moves.append((mod, kind, name, t))
    for (mod, kind, name, t), host in zip(moves, _host_like([m[3] for m in moves], pin)):
        host.copy_(t, non_blocking=True)
        _set(mod, kind, name, host)
    for d in {m[3].device for m in moves}:
        _sync(d)
    return pair


@torch.no_grad()
def stage_to_device(pair: Pair, device) -> Pair:
    """Move the pair's tensors to `device` (copies from pinned memory are
    asynchronous on the current stream). Returns the pair."""
    device = _device(device)
    for mod, kind, name in _slots(pair):
        t = _get(mod, kind, name)
        if t.device != device:
            _set(mod, kind, name, t.to(device, non_blocking=True))
    _sync(device)
    return pair


def _layout(pair: Pair):
    return [(kind, name, tuple(_get(mod, kind, name).shape), _get(mod, kind, name).dtype)
            for mod, kind, name in _slots(pair)]


class ExpertStager:
    """Keeps one pair resident on `device` and the other on the host; ``swap()`` flips
    them. Both pairs must have the same layout (the same names, shapes and dtypes, as
    two experts of one config and their ControlNets have), because the swap exchanges
    them slot by slot.

    device_place: ``device_place(pair) -> pair`` gives each tensor of a pair the layout
    it takes on the device, as JAX's ``device_place`` does; under a mesh it keeps this
    rank's shards (``parallel/sharding.py::place``). It is applied to both pairs before
    either moves, so each rank stages only its own shards to host memory and back."""

    def __init__(self, active: Pair, standby: Pair, device, device_place=None):
        self.device = _device(device)
        if device_place is not None:
            active, standby = device_place(active), device_place(standby)
        a, s = _layout(active), _layout(standby)
        if a != s:
            diff = next((x, y) for x, y in zip(a + [None], s + [None]) if x != y)
            raise ValueError(f"the pairs differ in layout at {diff[0]} / {diff[1]}")
        self.standby = stage_to_host(standby, pin_memory=self.device.type == "cuda")
        self.active = stage_to_device(active, self.device)

    @torch.no_grad()
    def swap(self) -> Pair:
        for (am, ak, an), (sm, sk, sn) in zip(_slots(self.active), _slots(self.standby)):
            resident, host = _get(am, ak, an), _get(sm, sk, sn)
            incoming = host.to(self.device, non_blocking=True, copy=True)
            host.copy_(resident, non_blocking=True)    # after the read above, same stream
            _set(sm, sk, sn, incoming)
            _set(am, ak, an, host)
        _sync(self.device)
        self.active, self.standby = self.standby, self.active
        return self.active
