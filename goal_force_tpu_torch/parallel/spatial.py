"""The VAE encoder's spatial split over ("sp", "tp"): what GSPMD does for JAX's training.

JAX's train step (``goal_force_tpu/training/train_step.py:141-165``) constrains the
pixel-space inputs of its three encodes to ("dp", None, "sp", "tp", None): the rows split
over "sp", the columns over "tp", and GSPMD exchanges the convolutions' halos. On a mesh
with a "pp" axis the rows split over ("pp", "sp"), "pp" major (JAX ``train_step.py:152``:
the encodes run before the pipelined trunk, on every rank). Here each
rank of a rows-by-columns group encodes its own block of rows and columns with explicit halos
(``collectives.shift`` without wraparound: the ranks at the image's edge receive zeros,
the convolution's own zero padding), and the latents are gathered back whole.

Rows and columns split in blocks of the encoder's total stride (8), dealt out as evenly
as the axis allows, the larger shares first: so a block of pixels maps to whole latent
rows, and each downsample halves every rank's range exactly. Where an axis is larger than
the number of blocks the last ranks hold nothing; they still join every exchange
(sending zeros) and skip the convolutions. An axis of size 1 is not split: its
convolutions keep their padding, so over one rank the encode runs the same convolutions
as the whole one.

Per layer of the encoder (``models/vae.py::encode``): each 3x3x3 convolution takes one row
from each neighbour over the row axes, then one column from each neighbour over "tp", the new rows
included (the corners arrive that way); the 1x1x1 convolutions, the norms (over channels,
per pixel) and the time downsample need nothing; ``downsample_spatial``'s zero row and
column below and to the right become the first row of the rank below and the first column
of the rank to the right; the mid-block's per-frame attention gathers its keys and values
over the group, each rank attending with its own queries. The encoder is frozen and runs
without grad, so none of this needs a backward.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from goal_force_tpu_torch.parallel import collectives as col
from goal_force_tpu_torch.parallel.mesh import current_mesh

Ranges = List[Tuple[int, int]]


def deal(size: int, n: int, block: int) -> Ranges:
    """Each of n ranks' range [a, b) of `size` rows, in blocks of `block` rows dealt as
    evenly as possible (the larger shares first, the last block possibly short)."""
    blocks = -(-size // block)
    base, extra = divmod(blocks, n)
    out, a = [], 0
    for i in range(n):
        b = min(a + (base + (i < extra)) * block, size)
        out.append((a, b))
        a = b
    return out


def _halve(ranges: Ranges, size: int) -> Ranges:
    """The ranges after a stride-2 downsample of `size` rows (to size // 2): a rank
    computes the output rows whose first input row it holds."""
    half = size // 2
    return [(min(-(-a // 2), half), min(-(-b // 2), half)) for a, b in ranges]


def row_axes() -> tuple:
    """The axes the rows split over: ("pp", "sp") on a mesh with a "pp" axis, else
    ("sp",)."""
    mesh = current_mesh()
    return ("pp", "sp") if mesh is not None and "pp" in mesh.mesh_dim_names else ("sp",)


class SpatialSplit:
    """Every rank's rows (over ``row_axes()``) and columns (over "tp") of one level of the
    encoder, for this rank of the ambient mesh. ``halve`` moves it to the next level
    after a spatial downsample."""

    def __init__(self, height: int, width: int, block: int):
        self.rows = row_axes()
        self.sp, self.tp = col._Axis(self.rows), col._Axis("tp")
        self.size = [height, width]
        self.ranges = [deal(height, self.sp.n, block), deal(width, self.tp.n, block)]

    @property
    def split_any(self) -> bool:
        return self.sp.n > 1 or self.tp.n > 1

    def mine(self, i: int) -> Tuple[int, int]:
        return self.ranges[i][(self.sp, self.tp)[i].rank]

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor x (B, T, H, W, ...)."""
        for i in range(2):
            a, b = self.mine(i)
            x = x.narrow(2 + i, a, b - a)
        return x

    def halve(self) -> None:
        self.ranges = [_halve(r, s) for r, s in zip(self.ranges, self.size)]
        self.size = [s // 2 for s in self.size]

    # -- exchanges ------------------------------------------------------------

    def _edge(self, x, dim, first: bool):
        """x's first or last row (or column) along `dim`; zeros where x has none."""
        if x.shape[dim] == 0:
            shape = list(x.shape)
            shape[dim] = 1
            return x.new_zeros(shape)
        return x.narrow(dim, 0 if first else x.shape[dim] - 1, 1)

    def _with_halo(self, x, dim, axis):
        """x with its neighbours' edge rows along `dim` attached over `axis` (zeros at the
        image's edge): the last row of the rank before, the first of the rank after."""
        before = col.shift(self._edge(x, dim, False), axis, 1, wrap=False)
        after = col.shift(self._edge(x, dim, True), axis, -1, wrap=False)
        return torch.cat([before, x, after], dim=dim)

    def halo(self, x: torch.Tensor, padding) -> Tuple[torch.Tensor, tuple]:
        """(B, C, T, h, w) -> x with one row from each neighbour over a split "sp", then
        one column from each neighbour over a split "tp" (the new rows included), and the
        padding (t, h, w) left to the convolution: 0 along a split axis."""
        padding = list(padding)
        for i, (axis, n) in enumerate(((self.rows, self.sp.n), ("tp", self.tp.n))):
            if padding[1 + i] and n > 1:
                if padding[1 + i] != 1:
                    raise ValueError(f"the split exchanges one-pixel halos, got {padding}")
                x = self._with_halo(x, 3 + i, axis)
                padding[1 + i] = 0
        return x, tuple(padding)

    def pad_after(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, h, w) with one row below and one column to the right: the next rank's
        first along a split axis (the rows first, so the corner arrives), zeros
        otherwise (``downsample_spatial``'s ZeroPad2d((0, 1, 0, 1)), into which the
        neighbours' row and column are written)."""
        out = F.pad(x, (0, 1, 0, 1))
        if self.sp.n > 1:
            out[..., -1:, :-1] = col.shift(self._edge(x, 3, True), self.rows, -1, wrap=False)
        if self.tp.n > 1:
            out[..., -1:] = col.shift(self._edge(out, 4, True), "tp", -1, wrap=False)
        return out

    def conv(self, x, weight, bias, stride, padding):
        """F.conv2d or F.conv3d (by the weight's rank) of this rank's block, with the
        halos its padding needs (``halo``, 3D only) and, where the rank's block holds no
        pixel, an empty output of the right shape."""
        conv = F.conv3d if weight.dim() == 5 else F.conv2d
        if weight.dim() == 5:
            x, padding = self.halo(x, padding)
        k = weight.shape[2:]
        out = [(i + 2 * p - kk) // s + 1 for i, p, kk, s in zip(x.shape[2:], padding, k, stride)]
        if min(out) <= 0 or x.shape[0] == 0:
            return x.new_empty((x.shape[0], weight.shape[0], *(max(o, 0) for o in out)))
        return conv(x, weight, bias, stride=stride, padding=padding)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor (B, T, H, W, ...) of this level from every rank's block: the
        blocks padded to the largest, one all-gather over ("sp", "tp"), and each rank's
        part cut out and put in its place."""
        (rows, cols), (rh, cw) = self.ranges, (self.mine(0), self.mine(1))
        big = [max(b - a for a, b in r) for r in (rows, cols)]
        pad = [0] * (2 * x.dim())
        pad[2 * (x.dim() - 3) + 1] = big[0] - (rh[1] - rh[0])
        pad[2 * (x.dim() - 4) + 1] = big[1] - (cw[1] - cw[0])
        parts = col._all_gather(F.pad(x, pad), col._Axis(self.rows + ("tp",)))
        out = []
        for s, (a, b) in enumerate(rows):
            row = [parts[s * len(cols) + t].narrow(2, 0, b - a).narrow(3, 0, d - c)
                   for t, (c, d) in enumerate(cols)]
            out.append(torch.cat(row, dim=3))
        return torch.cat(out, dim=2)


def split_encode_video(vae, cfg, video: torch.Tensor) -> torch.Tensor:
    """``models/vae.py::encode_video`` of the whole video (B, T, H, W, 3), split over
    the row axes and "tp" of the ambient mesh: each rank encodes its block of rows and
    columns, and every rank gets the whole latents (B, L, H/8, W/8, z)."""
    from goal_force_tpu_torch.models import vae as vaem

    split = SpatialSplit(video.shape[2], video.shape[3], cfg.upsampling_factor)
    z = vaem.encode_video(vae, cfg, split.take(video), split=split)
    return split.gather(z)     # the split is at the latents' level now

