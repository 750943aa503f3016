"""The plan of the decode path's GEMV (``csrc/skinny.cuh``): how many
contraction slices (cluster ranks) and how many columns a tile, for
``adapter_fuse`` at T <= 8 and ``quant_matmul`` at M <= 8.

The wrappers pass the plan to the kernel, which checks it; the CPU tests
take the same plan to model the kernel's summation order. The constants
are ``skinny.cuh``'s.

* rows: M rounded up to a power of two (1, 2, 4, 8), the kernel's
  instantiation;
* lane: the columns a lane loads from a weight row at once, a 16-byte
  vector unless rows x lane would pass 64 f32 accumulators (int8 at
  M > 4, int4 at M > 2);
* cols and ranks: one wave of blocks, with the widest tiles that still
  give the card some parallelism. A tile is at most one 128-column
  quantization block and at least 64 bytes of a weight row (two sectors a
  row; so int4 tiles are always 128 columns). For each width, widest
  first, ranks is the most, up to 8, whose tiles x ranks blocks fit one
  wave (at most 90 % of two blocks an SM: the card holds 30 clusters of 8
  blocks, 62 of 4), and no more than a contraction of 32 rows a rank
  allows; the first width whose blocks reach a quarter of the SMs is
  taken. At internlm2-1.8b's decode shapes: ``adapter_fuse`` f32
  (2048, 256) 8 tiles of 32 columns x 8 ranks; ``quant_matmul`` int8
  128-column tiles, 8 ranks, but 3 at N = 8192.

The plan was chosen by ``skinny_variants.py`` on the card (PERF.md): the
launch and each cluster barrier cost ~1 µs and ~0.7 µs, so a second wave
of blocks costs more than wider tiles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

SKINNY_ROWS = 8   # rows of x at most on this path (skinny.cuh MAX_ROWS)
WARPS = 8         # a block's warps (skinny.cuh WARPS)
MAX_COLS = 128    # a tile's columns at most: one quantization block
MAX_RANKS = 8     # the portable cluster size
MAX_ACC = 64      # f32 accumulators a lane holds
MIN_SLICE = 32    # contraction rows a rank takes at least
MIN_SEGMENT = 64  # bytes of a weight row a tile reads at least


class Plan(NamedTuple):
    rows: int   # the kernel's ROWS
    lane: int   # columns a lane loads from a row
    ranks: int  # contraction slices, the cluster's blocks
    cols: int   # columns a tile

    @property
    def row_lanes(self) -> int:
        """Lanes of a block that take distinct weight rows."""
        return WARPS * 32 // (self.cols // self.lane)


@functools.lru_cache(maxsize=512)
def plan(M: int, K: int, N: int, bits: int, sms: int) -> Plan:
    """The plan for x (M, K) @ W (K, N) with ``bits``-bit weights (32 f32,
    16 bf16, 8 int8, 4 int4) on a card of ``sms`` SMs."""
    if not (1 <= M <= SKINNY_ROWS and K >= 1 and N >= 1 and bits in (32, 16, 8, 4)):
        raise ValueError(f"no skinny plan for M={M} K={K} N={N} bits={bits}")
    rows = 1 << (M - 1).bit_length()
    lane = min(128 // bits, MAX_ACC // rows)
    wave = 2 * sms * 9 // 10
    max_ranks = max(1, min(MAX_RANKS, -(-K // MIN_SLICE)))
    cols = MAX_COLS
    while True:
        tiles = -(-N // cols)
        ranks = max(1, min(max_ranks, wave // tiles))
        narrower = cols // 2
        if tiles * ranks >= sms // 4 or narrower < max(lane, MIN_SEGMENT * 8 // bits):
            return Plan(rows, lane, ranks, cols)
        cols = narrower


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(t: torch.Tensor, M: int, K: int, N: int, bits: int) -> Plan:
    """:func:`plan` on ``t``'s card."""
    return plan(M, K, N, bits, _sms(t.device.index))
