"""Post-reconciliation stages: error verification + privacy amplification.

The reference stops at reconciliation and checks ``keys_match`` against
Alice's key directly — an oracle only a simulation has
(``src/qkd_ldpc_algorithm.cpp:382``).  A deployed QKD post-processor
needs the two stages that follow:

- **Error verification**: syndrome convergence does NOT imply key
  equality (undetected frame errors decode to a different codeword
  coset member).  Both sides exchange a short universal hash of the
  reconciled key and discard frames that disagree; the residual
  undetected-error probability is 2^-out_bits.
- **Privacy amplification**: compress the verified key by the disclosed
  information (syndrome bits, verification hash, revealed bits — the
  ``leak_bits`` accounting carried by `serve.Reconciler`,
  `decoder.RateAdapter`, and `decoder.blind`) plus a security margin,
  with a 2-universal hash.

Both use seeded binary TOEPLITZ hashing — the standard 2-universal
family (Krawczyk; Mauerer et al.): ``T[i, j] = s[i - j + n - 1]`` from a
shared random seed sequence of n + k - 1 bits, so the classical channel
carries only the seed.  The GF(2) matvec runs as a matrix product:
bf16 0/1 operands, f32 accumulation (exact — row sums are bounded by n
<< 2^24), parity taken mod 2.

Two evaluation paths, bit-identical (same seed stream, same matrix —
tests/test_postprocess.py):

- **dense** — materialize T once, one [B, n] x [n, k] matmul.  Right for
  tag-sized outputs and small frames; at production frame sizes the
  matrix itself is the problem (N=262,144 -> a [~125k, 262k] bf16 T is
  ~61 GB: cannot exist on device).
- **blocked** (round 4) — exploit that T with SQUARE [c, c] blocks is
  block-Toeplitz: only nI + nJ - 1 distinct blocks exist.  Build them
  once (int8, vectorized shear tiling) and accumulate out_block[I] +=
  D[I - J] @ x_block[J] with one aligned contiguous D-slice + one
  matmul per J.  int8 operands with int32 accumulation are exact (row
  sums <= n, far below 2^31), so the parity is exact.  Peak memory is
  O((n/c + k/c) * c^2 + k*B) regardless of frame size; this is what
  lets amplification run at the frame sizes the decoder itself serves
  (benchmarks/frame_scale.py); the round-3 two-level tile stream it
  replaced built every tile from scratch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def toeplitz_matrix(seed_key: jax.Array, n_in: int, n_out: int) -> jax.Array:
    """Binary Toeplitz matrix [n_out, n_in] from n_in + n_out - 1 seeded
    bits (the shared classical message, here derived from a PRNG key both
    sides hold).

    Built by the shear-tiling identity (contiguous copies only):
    tiling a period-(L + 1) sequence into rows of length L = n_in +
    n_out - 1 shifts each row's phase by one, so with v = flip(s) + one
    junk element, columns [n_out - 1, n_out - 1 + n_in) are exactly
    T[i, j] = s[i - j + n_in - 1].  The fancy-indexing formulation is a
    [n_out * n_in]-element gather, far slower.
    """
    if n_out < 1 or n_in < 1:
        raise ValueError("hash dimensions must be >= 1")
    s = jax.random.bernoulli(seed_key, 0.5, (n_in + n_out - 1,))
    L = n_in + n_out - 1
    v = jnp.concatenate([jnp.flip(s), jnp.zeros((1,), s.dtype)])
    t = jnp.broadcast_to(v, (n_out, L + 1)).reshape(-1)[: n_out * L]
    return t.reshape(n_out, L)[
        :, n_out - 1 : n_out - 1 + n_in
    ].astype(jnp.bfloat16)


@jax.jit
def _hash_apply(T: jax.Array, bits: jax.Array) -> jax.Array:
    # MXU matmul: bf16 0/1 inputs, f32 accumulation is exact for row sums
    # bounded by n_in (<< 2^24); parity = mod 2.
    acc = jax.lax.dot_general(
        bits.astype(jnp.bfloat16), T.T,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return (acc.astype(jnp.int32) & 1).astype(jnp.uint8)


def _build_diag_stack(s, n_in: int, n_out: int, c: int) -> jax.Array:
    """[nD, c, c] int8 stack of the distinct block-Toeplitz diagonals,
    built by vectorized shear tiling (contiguous copies only — see
    :func:`_hash_apply_blocked` for the derivation)."""
    nI = -(-n_out // c)
    nJ = -(-n_in // c)
    nD = nI + nJ - 1
    Np, Mp = nJ * c, nI * c
    # s' = [Np - n_in zeros | s | Mp - n_out zeros]: the front zeros
    # pair with the zero-padded tail of x (columns j >= n_in), the rear
    # zeros land in discarded rows (i >= n_out) — never observed.
    # Block (I, J) entry (a, b) is s'[c*(I - J) + (a - b) + Np - 1], so
    # local_e = s'[c*e : c*e + 2c - 1] with e = I - J + nJ - 1.
    spad = jnp.concatenate([
        jnp.zeros((Np - n_in,), jnp.int8), s.astype(jnp.int8),
        jnp.zeros((Mp - n_out,), jnp.int8),
    ])  # [Mp + Np - 1]
    A = jnp.concatenate([spad, jnp.zeros((1,), jnp.int8)]).reshape(nD + 1, c)
    locs = jnp.concatenate([A[:-1], A[1:, : c - 1]], axis=1)  # [nD, 2c-1]
    V = jnp.concatenate(
        [jnp.flip(locs, axis=1), jnp.zeros((nD, 1), jnp.int8)], axis=1
    )  # [nD, 2c]
    Vr = jnp.concatenate([V[:, c - 1 :], V[:, : c - 1]], axis=1)
    return (
        jnp.broadcast_to(Vr[:, None, :], (nD, c, 2 * c))
        .reshape(nD, 2 * c * c)[:, : c * (2 * c - 1)]
        .reshape(nD, c, 2 * c - 1)[:, :, :c]
    )


def _pad_frame_blocks(bits, n_in: int, nJ: int, c: int) -> jax.Array:
    """[nJ, c, B] int8 zero-extended column blocks of the frame batch."""
    return (
        jnp.pad(bits, ((0, 0), (0, nJ * c - n_in)))
        .astype(jnp.int8).T.reshape(nJ, c, bits.shape[0])
    )


@partial(jax.jit, static_argnames=("n_in", "n_out", "c"))
def _hash_apply_blocked(
    s: jax.Array,  # [n_in + n_out - 1] seed bits (the classical message)
    bits: jax.Array,  # [B, n_in] uint8
    n_in: int,
    n_out: int,
    c: int,  # square block size
) -> jax.Array:
    """Streaming block-Toeplitz hash: T is never materialized in full.

    With SQUARE [c, c] blocks, T is block-Toeplitz: block (I, J) of
    T[i, j] = s[i - j + n_in - 1] depends only on the diagonal d = I - J,
    so only nI + nJ - 1 distinct blocks exist (245 + 512 = 757 at the
    262k production shape) instead of nI * nJ tiles (125,440).  All
    distinct blocks are built ONCE per call as an int8 [nD, c, c] stack
    via vectorized shear tiling, then the product accumulates

        out_block[I] += D[I - J] @ x_block[J]      for J = 0..nJ-1

    where each scan step's LHS is a CONTIGUOUS [nI*c, c] row-slice of
    the stack (the nI diagonals that pair with x_block[J], e = I - J +
    nJ - 1 being consecutive in I) — an aligned dynamic_slice, one
    matmul, one full-width add.  int8 operands with int32 accumulation
    are exact (row sums <= n_in << 2^31); parity mod 2 at the end.

    The round-3 path built EVERY [bo, bi] tile from scratch (write +
    read ~2 passes over n_out*n_in bf16 material, plus an unaligned
    offset slice per tile); here tile material is nD*c*c int8 built
    once, and the dominant traffic is the D-stack re-read per scan step
    (~nJ * nI*c*c int8 — at 262k, 33 GB vs the round-3 ~130+ GB).  Not
    yet timed on the GPU.

    Shear tiling (contiguous copies only, no gathers): broadcasting a
    period-(2c) vector into rows of length 2c - 1 shifts each row's
    phase by one.  With v = [flip(local), 0] rotated left by c - 1, the
    [c, c] Toeplitz block D[e][a, b] = local_e[a - b + c - 1] lands in
    columns [0, c) — an aligned slice (the round-3 tile sliced at column
    bo - 1, an unaligned offset forcing a relayout per tile).  Gather
    (4M single-element reads per tile), 1-D conv_general_dilated and FFT
    formulations of the same product were rejected earlier; none has
    been timed on the GPU.
    """
    B = bits.shape[0]
    nI = -(-n_out // c)
    nJ = -(-n_in // c)
    Dflat = _build_diag_stack(s, n_in, n_out, c).reshape(-1, c)
    xb = _pad_frame_blocks(bits, n_in, nJ, c)

    def step(acc, J):
        # Diagonals pairing x_block[J] with every I: e = I + (nJ-1-J),
        # I = 0..nI-1 — rows [(nJ-1-J)*c, (nJ-1-J+nI)*c) of Dflat.
        Dwin = jax.lax.dynamic_slice(
            Dflat, ((nJ - 1 - J) * c, 0), (nI * c, c)
        )
        acc = acc + jax.lax.dot_general(
            Dwin, xb[J], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return acc, None

    acc, _ = jax.lax.scan(
        step, jnp.zeros((nI * c, B), jnp.int32),
        jnp.arange(nJ, dtype=jnp.int32),
    )
    return (acc[:n_out] & 1).astype(jnp.uint8).T


@partial(jax.jit, static_argnames=("n_in", "n_out", "c"))
def _hash_apply_blocked_xor(
    s: jax.Array, bits: jax.Array, n_in: int, n_out: int, c: int
) -> jax.Array:
    """:func:`_hash_apply_blocked` with XOR-parity accumulation.

    Parity of a sum equals the XOR of parities, so each scan step
    reduces its block product mod 2 immediately and the carried
    accumulator is int8 instead of int32 — quartering the accumulator's
    read+write traffic per step (the per-J scan re-touches the full
    [nI*c, B] carry every step).  Bit-identical to every other path
    (tests/test_postprocess.py); hardware A/B vs "blocked"/"blocked-diag"
    in benchmarks/amplify_lab.py decides the production default.
    """
    B = bits.shape[0]
    nI = -(-n_out // c)
    nJ = -(-n_in // c)
    Dflat = _build_diag_stack(s, n_in, n_out, c).reshape(-1, c)
    xb = _pad_frame_blocks(bits, n_in, nJ, c)

    def step(acc, J):
        Dwin = jax.lax.dynamic_slice(
            Dflat, ((nJ - 1 - J) * c, 0), (nI * c, c)
        )
        y = jax.lax.dot_general(
            Dwin, xb[J], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return acc ^ (y & 1).astype(jnp.int8), None

    acc, _ = jax.lax.scan(
        step, jnp.zeros((nI * c, B), jnp.int8),
        jnp.arange(nJ, dtype=jnp.int32),
    )
    return acc[:n_out].astype(jnp.uint8).T


@partial(jax.jit, static_argnames=("n_in", "n_out", "c"))
def _hash_apply_blocked_diag(
    s: jax.Array, bits: jax.Array, n_in: int, n_out: int, c: int
) -> jax.Array:
    """Per-DIAGONAL block-Toeplitz hash: the D stack is read exactly once.

    The per-J scan of :func:`_hash_apply_blocked` re-reads an
    [nI*c, c] window of the diagonal stack every step (~nJ * nI * c^2
    int8 — the dominant traffic, ~33 GB at the 262k production shape).
    Scanning per DIAGONAL e instead pairs ONE [c, c] block with a
    contiguous [c, nI*B] window of the zero-extended frame matrix
    (out block I accumulates D[e] @ x[I - e + nJ - 1]; for fixed e
    those x blocks are consecutive), so the total traffic is
    nD * (c^2 + 2 * c * nI * B) int8 — at 262k/c=256/B=32 about 18 GB,
    roughly half of "blocked".  XOR-parity accumulation keeps the
    [c, nI*B] carry int8.  Bit-identical to every other path; the
    hardware A/B in benchmarks/amplify_lab.py decides the default.
    """
    B = bits.shape[0]
    nI = -(-n_out // c)
    nJ = -(-n_in // c)
    nD = nI + nJ - 1
    D = _build_diag_stack(s, n_in, n_out, c)
    xb = _pad_frame_blocks(bits, n_in, nJ, c)
    z = jnp.zeros((nI - 1, c, B), jnp.int8)
    Xmat = (
        jnp.concatenate([z, xb, z], axis=0)
        .transpose(1, 0, 2).reshape(c, -1)
    )  # column group p holds x block p - (nI - 1)

    def step(acc, e):
        De = jax.lax.dynamic_index_in_dim(D, e, 0, keepdims=False)
        win = jax.lax.dynamic_slice(
            Xmat, (0, (nI + nJ - 2 - e) * B), (c, nI * B)
        )
        y = jax.lax.dot_general(
            De, win, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return acc ^ (y & 1).astype(jnp.int8), None

    acc, _ = jax.lax.scan(
        step, jnp.zeros((c, nI * B), jnp.int8),
        jnp.arange(nD, dtype=jnp.int32),
    )
    out = acc.reshape(c, nI, B).transpose(1, 0, 2).reshape(nI * c, B)
    return out[:n_out].astype(jnp.uint8).T


_BLOCKED_KERNELS = {
    "blocked": _hash_apply_blocked,
    "blocked-xor": _hash_apply_blocked_xor,
    "blocked-diag": _hash_apply_blocked_diag,
}
# Which streaming formulation "auto" resolves to.  All three are
# bit-identical; the choice is purely a bandwidth question, not yet
# measured on the GPU (ROADMAP.md, Queue 1).
_BLOCKED_DEFAULT = "blocked"

# Above this many T entries the dense path materializes an unreasonable
# matrix (2^26 bf16 = 128 MB) and the streaming path takes over.
_DENSE_LIMIT = 1 << 26


def toeplitz_hash(
    bits: jax.Array,
    seed_key: jax.Array,
    n_out: int,
    block_out: int = 256,  # output is bit-identical for any block size
    method: str = "auto",  # "auto" | "dense" | "blocked" | "blocked-xor"
    #                        | "blocked-diag"
) -> jax.Array:
    """Hash key frames [B, n] (or [n]) to [B, n_out] (or [n_out]) bits.

    ``method='auto'`` uses the dense matmul for tag-sized work and the
    streaming block-Toeplitz path (``_BLOCKED_DEFAULT`` formulation)
    once T would exceed ~128 MB; every method produces bit-identical
    output for the same seed.
    """
    arr = jnp.atleast_2d(jnp.asarray(bits, jnp.uint8))
    n_in = arr.shape[-1]
    if method == "auto":
        method = (
            "dense" if n_in * n_out <= _DENSE_LIMIT else _BLOCKED_DEFAULT
        )
    if method == "dense":
        T = toeplitz_matrix(seed_key, n_in, n_out)
        out = _hash_apply(T, arr)
    elif method in _BLOCKED_KERNELS:
        s = jax.random.bernoulli(seed_key, 0.5, (n_in + n_out - 1,)).astype(
            jnp.int8
        )
        out = _BLOCKED_KERNELS[method](
            s, arr, n_in, n_out, min(block_out, n_out)
        )
    else:
        raise ValueError(f"Unknown method {method!r}")
    return out[0] if jnp.asarray(bits).ndim == 1 else out


def verification_tags(bits: jax.Array, seed_key: jax.Array,
                      tag_bits: int = 64) -> jax.Array:
    """Short verification hash per frame ([.., tag_bits] uint8).

    Alice and Bob each compute tags over their (reconciled) keys with the
    same seed and exchange them; a mismatch flags an undetected frame
    error (probability of a wrong frame passing: 2^-tag_bits).  The tag
    itself is disclosed — count ``tag_bits`` into the leakage budget.
    """
    return toeplitz_hash(bits, seed_key, tag_bits)


def amplified_key_bits(payload_bits: int, leak_bits: int,
                       tag_bits: int = 64, security_bits: int = 100) -> int:
    """Final-key length after privacy amplification: payload minus all
    disclosed information minus the security parameter (the standard
    leftover-hash-lemma budget; returns 0 if the frame yields no key)."""
    return max(0, payload_bits - leak_bits - tag_bits - security_bits)


def privacy_amplify(bits: jax.Array, seed_key: jax.Array,
                    final_bits: int) -> jax.Array:
    """Compress verified key frames to ``final_bits`` with a 2-universal
    Toeplitz hash ([.., final_bits] uint8)."""
    if final_bits < 1:
        raise ValueError(
            "no key material left after the leakage budget; use a lower "
            "rate (shorten) or a better channel"
        )
    return toeplitz_hash(bits, seed_key, final_bits)
