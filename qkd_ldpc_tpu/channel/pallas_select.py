"""Pallas-Triton kernel for the channel's exact k-th-smallest threshold.

The exact-weight channel (channel.keys) finds the k-th smallest of each
row of i.i.d. uint32 scores with a 32-pass bitwise prefix search.  As
XLA ops every pass re-reads the whole [B, N] score block from device
memory.  This kernel gives each row to one program, loads the row into
registers ONCE and runs all 32 passes on chip, so the scores cross
device memory exactly once.

Exactness: the same integer algorithm bit-for-bit.  uint32 order is
kept through the sign-flip trick (``u ^ 0x80000000`` compared as int32),
and columns past N (the row is padded to a power of two, as Triton
blocks must be) read as the maximal value, which never changes the k-th
smallest for k <= N.  The tie-completion logic stays in XLA
(channel.keys._exact_weight_mask) and consumes this threshold
identically, so flip masks are bit-identical to the XLA search
(tests/test_channel.py).

Rows wider than ``MAX_KERNEL_COLS`` (the 65k/262k frames of
benchmarks/frame_scale.py) do not fit one program's registers; the
dispatch in channel.keys sends them to the XLA search.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_SIGN = -0x80000000  # 0x80000000 as an int32 literal (sign-flip bit)
_FLIPPED_MAX = 0x7FFFFFFF  # 0xFFFFFFFF after the sign flip

# Widest row one program holds in registers (padded to a power of two).
MAX_KERNEL_COLS = 32768


def fits_kernel(n_cols: int) -> bool:
    """True when one score row fits the kernel's single-program block."""
    return 0 < n_cols <= MAX_KERNEL_COLS


def _kth_kernel(k_ref, s_ref, o_ref, *, n: int, n_pad: int):
    """One row: 32-pass bitwise prefix search over register-resident scores.

    ``s_ref`` holds int32 bits of (u32 ^ 0x80000000), so signed order ==
    the original unsigned order; ``prefix``/``test`` carry the RAW u32
    bit pattern, and only the comparison runs in sign-flipped space.
    """
    cols = jax.lax.broadcasted_iota(jnp.int32, (n_pad,), 0)
    s = plgpu.load(s_ref, mask=cols < n, other=_FLIPPED_MAX)
    s = jnp.where(cols < n, s, _FLIPPED_MAX)
    k = k_ref[...]  # [1]

    def step(j, prefix):
        test = prefix | jax.lax.shift_left(jnp.int32(1), 31 - j)
        cnt = jnp.sum((s < (test ^ _SIGN)).astype(jnp.int32))
        return jnp.where(cnt >= k, prefix, test)

    o_ref[...] = jax.lax.fori_loop(0, 32, step, jnp.zeros((1,), jnp.int32))


@partial(jax.jit, static_argnames=("interpret",))
def kth_smallest_kernel(
    scores: jax.Array,  # [B, N] uint32
    k: jax.Array,  # scalar or [B] int32 (traced)
    interpret: bool = False,
) -> jax.Array:
    """k-th smallest per row of uint32 scores -> [B, 1] uint32."""
    B, N = scores.shape
    if not fits_kernel(N):
        raise ValueError(
            f"row of {N} scores exceeds the kernel's {MAX_KERNEL_COLS} columns"
        )
    n_pad = max(16, pl.next_power_of_2(N))
    flipped = jax.lax.bitcast_convert_type(
        scores ^ jnp.uint32(0x80000000), jnp.int32
    )
    k_rows = jnp.broadcast_to(jnp.asarray(k, jnp.int32), (B,))
    out = pl.pallas_call(
        partial(_kth_kernel, n=N, n_pad=n_pad),
        out_shape=jax.ShapeDtypeStruct((B,), jnp.int32),
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (i,)),
            pl.BlockSpec((None, n_pad), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((1,), lambda i: (i,)),
        compiler_params=plgpu.CompilerParams(
            num_warps=min(16, max(4, n_pad // 2048)), num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name="kth_smallest",
    )(k_rows, flipped)
    # The kernel's prefix is already the raw u32 bit pattern.
    return jax.lax.bitcast_convert_type(out, jnp.uint32)[:, None]
