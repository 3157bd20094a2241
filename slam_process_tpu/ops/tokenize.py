"""Device-side hex tokenization for stride-regular serial logs.

The reference tokenizes with a per-token Python regex loop
(serial_hex_to_excel_v3.py:18-36); this engine also has a numpy mask pass
and a native C scanner (io/hexlog.py, runtime/hexscan.c), but both run on
one host core.

This module moves tokenization onto the device.  Every shipped log is a short
junk prefix (the 2-byte UTF-8 guillemet + separator) followed by a perfectly
regular ``"XX "`` stride-3 token stream, so on device the tokenize is a
``[T, 3]`` reshape plus uint8 arithmetic — no gathers, no compaction, and it
fuses into the decode program (ops/decode.decode_rows_jax) so the raw TEXT
bytes are the only host->device traffic.

Correctness is never assumed: the kernel also computes a ``regular`` flag —
True iff every real token triple is (hex, hex, whitespace).  Combined with
the host-side precondition established by :func:`stride3_offset` (no valid
token before the body start, and the body starts at a token boundary), the
flag being True PROVES the stride output equals the reference tokenizer's
output (see the equivalence argument in ``tokenize_stride3_jax``'s
docstring).  Callers fall back to the host tokenizer when the flag is False
or the offset scan fails — irregular streams are slower, never wrong.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

# Non-whitespace runs; token validity per the reference regex
# (serial_hex_to_excel_v3.py:16): two hex digits, optionally 0x/0X-prefixed.
_NONWS_RUN = re.compile(rb"[^ \t\r\n\x0b\x0c\x1c\x1d\x1e\x1f]+")
_VALID_TOKEN = re.compile(rb"^(?:0[xX])?[0-9a-fA-F]{2}$")

#: Padding byte for the text tensor: whitespace, so a final 2-hex token with
#: no trailing separator in the file still passes the (hex, hex, ws) check.
TEXT_PAD = 0x20


def stride3_offset(data: bytes, max_scan: int = 4096) -> Optional[int]:
    """Find the stride-3 body start: byte offset of the FIRST valid token.

    Establishes the host-side precondition for the device stride tokenizer:
    ``data[:p]`` contains no valid token (p is the first one), and ``p`` is
    a token boundary (starts a non-whitespace run).  Only the leading
    ``max_scan`` bytes are scanned — logs whose first valid token lies
    beyond that (megabytes of junk) take the host fallback path.

    Returns None when no valid token starts in the scan window (junk-only
    heads, empty streams) — callers must use the host tokenizer then.
    """
    head = data[:max_scan]
    limit = len(head)
    for m in _NONWS_RUN.finditer(head):
        # A run truncated by the scan window may continue past it; its
        # in-window prefix is not the real token — stop, take the fallback.
        if m.end() == limit and len(data) > limit:
            return None
        if _VALID_TOKEN.match(m.group()):
            return m.start()
    return None


def prepare_text(data: bytes, p: int, target: int) -> Tuple[np.ndarray, int]:
    """Host prep: slice the body at offset ``p``, pad with whitespace.

    Returns (text[target] uint8, n_text).  ``target`` must be a multiple
    of 3 and >= len(data) - p.
    """
    body = np.frombuffer(data, dtype=np.uint8)[p:]
    if target % 3 != 0 or target < len(body):
        raise ValueError(f"bad text bucket {target} for body of {len(body)}")
    out = np.full(target, TEXT_PAD, dtype=np.uint8)
    out[: len(body)] = body
    return out, len(body)


def text_bucket(n_body: int, quantum: int = 3 << 18) -> int:
    """Round a body length up to a multiple-of-3 bucket size.

    The quantum is 3x the byte-domain bucket (pipeline/device.bucket_size's
    256 KiB): each token is 3 text bytes, so the padded TOKEN count — which
    is what every downstream per-frame stage scales with — matches the
    byte-path bucketing exactly.
    """
    if quantum % 3 != 0:
        raise ValueError("text bucket quantum must be a multiple of 3")
    return max(((n_body + quantum - 1) // quantum) * quantum, quantum)


def tokenize_stride3_jax(text, n_text):
    """Jittable stride-3 tokenizer: text bytes -> byte values + proof flag.

    ``text`` is [M] uint8 with M % 3 == 0, padded with whitespace
    (TEXT_PAD); ``n_text`` is the real body length (i32 scalar).  Returns
    ``(b[M//3] uint8, n_tok i32, regular bool)`` where b[k] is the value of
    token k (zero — an inert, non-flag byte — beyond ``n_tok``).

    Equivalence argument (tested over every shipped log and adversarial
    synthetics in tests/test_tokenize.py): let rem = n_text % 3.

    * rem == 0 or 2: every real body byte lies in a checked triple
      (the rem==2 tail's missing separator is supplied by the whitespace
      padding).  ``regular`` True means the body is exactly
      ``(hex hex ws) * n_tok`` (modulo the supplied final separator), so
      whitespace-splitting yields exactly the n_tok two-hex-digit tokens —
      the reference tokenizer accepts each and nothing else.
    * rem == 1: one real byte (the last) is unchecked; its preceding byte
      was verified whitespace, so it forms a lone 1-character token, which
      the reference regex rejects.  Equivalence holds with that token
      skipped — exactly what the reference does.

    LAYOUT (the whole performance story): a naive ``[M//3, 3]`` reshape
    with per-column slices puts the token on a 3-wide minor axis — 3 of 128
    lanes used, and every column slice is a stride-3 cross-lane shuffle.
    Instead the text
    reshapes to ``[M//384, 384]`` (128 tokens per row, minor axis = 3 full
    lane tiles), every per-byte classification runs elementwise in that
    layout, and the stride-3 deinterleave becomes ONE constant [384, 128]
    matmul (exact: bf16 inputs <= 42, weights {16, 1, 0} — bf16 x bf16
    products accumulate exactly in f32, sums <= 714 < 2^24, on any
    backend).  The 128-lane layout is not yet measured against a strided
    slice on the H100 (ROADMAP A7).
    Shapes not divisible by 384 (tiny tests) take the reshape path below —
    same semantics, covered by the same parity tests.
    """
    import jax.numpy as jnp

    def ishex(c):
        # uint8 wraparound makes the range tests two compares each:
        # '0'..'9' -> c-48 in [0,10); 'a'..'f' / 'A'..'F' -> (c|0x20)-97 in [0,6)
        return ((c - ord("0")) < 10) | (((c | 0x20) - ord("a")) < 6)

    def hexval(c):
        # '0'..'9': low nibble; letters: low nibble + 9 ('A'=0x41 -> 1+9=10).
        return (c & 0xF) + 9 * (c >> 6)

    def is_ws(c):
        return ((c == 0x20) | ((c >= 0x09) & (c <= 0x0D))
                | ((c >= 0x1C) & (c <= 0x1F)))

    m = text.shape[0]
    n_tok = (jnp.asarray(n_text).astype(jnp.int32) + 1) // 3

    if m % 384 == 0:
        t = text.reshape(-1, 384)                    # 128 tokens per row
        cls = jnp.arange(384, dtype=jnp.int32) % 3   # char position in token
        ok_elem = jnp.where(cls[None, :] < 2, ishex(t), is_ws(t))
        hv = hexval(t).astype(jnp.bfloat16)
        # Constant deinterleave operators: W_val combines (hi, lo) chars
        # into the byte value; W_cnt counts passing chars per token (== 3
        # iff the triple is (hex, hex, ws)).
        j = np.arange(384)
        w_val = np.zeros((384, 128), np.float32)
        w_val[j, j // 3] = np.where(j % 3 == 0, 16.0,
                                    np.where(j % 3 == 1, 1.0, 0.0))
        w_cnt = np.zeros((384, 128), np.float32)
        w_cnt[j, j // 3] = 1.0
        w_val_b = jnp.asarray(w_val, jnp.bfloat16)
        w_cnt_b = jnp.asarray(w_cnt, jnp.bfloat16)
        vals = jnp.dot(hv, w_val_b, preferred_element_type=jnp.float32)
        cnts = jnp.dot(ok_elem.astype(jnp.bfloat16), w_cnt_b,
                       preferred_element_type=jnp.float32)
        tok_ok = (cnts == 3.0).reshape(-1)
        b = vals.reshape(-1)
        real = jnp.arange(m // 3, dtype=jnp.int32) < n_tok
        regular = jnp.all(tok_ok | ~real)
        b = jnp.where(real & tok_ok, b, 0.0).astype(jnp.uint8)
        return b, n_tok, regular

    t = text.reshape(-1, 3)
    c0, c1, c2 = t[:, 0], t[:, 1], t[:, 2]
    real = jnp.arange(t.shape[0], dtype=jnp.int32) < n_tok
    tok_ok = ishex(c0) & ishex(c1) & is_ws(c2)
    regular = jnp.all(tok_ok | ~real)
    b = ((hexval(c0) << 4) | hexval(c1)).astype(jnp.uint8)
    b = jnp.where(real & tok_ok, b, jnp.uint8(0))
    return b, n_tok, regular


def tokenize_device(data: bytes) -> Tuple[np.ndarray, bool]:
    """Standalone host wrapper: tokenize a raw log on device.

    Returns (bytes uint8, used_device).  Falls back to the host numpy
    tokenizer when the stream is not stride-3 regular.  The fused pipeline
    (pipeline/device.run_session_from_text) is the production path — this
    wrapper exists for tests and ad-hoc use.
    """
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.io.hexlog import tokenize_hex

    p = stride3_offset(data)
    if p is None:
        return tokenize_hex(data), False
    body_len = len(data) - p
    text, n_text = prepare_text(data, p, text_bucket(body_len))
    fn = jax.jit(tokenize_stride3_jax)
    b, n_tok, regular = fn(jnp.asarray(text), jnp.int32(n_text))
    if not bool(regular):
        return tokenize_hex(data), False
    return np.asarray(b)[: int(n_tok)], True
