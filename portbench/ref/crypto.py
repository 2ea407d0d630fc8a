"""Frozen copy of ``echoseal_torch/core/crypto.py`` for the benchmark's traffic and
plain reference (it does not move with the program).

Host-side crypto: key schedule, AEAD seal/open, AES-CTR PN keystream.

Wire-identical to ``echoseal_tpu.core.crypto`` but built from the standard
library and numpy alone, so the port runs where the ``cryptography``
package is not installed:

* HKDF-SHA256 (RFC 5869, info=b"EchoSeal:KDF:v1", 64 bytes, no salt) over
  ``hmac`` -> aead_key (first 32) + prng_key (last 32).
* AEAD: IETF ChaCha20-Poly1305 (RFC 8439), 12-byte random nonce.  The
  ChaCha20 block function is vectorised in numpy over any number of
  (nonce, counter) blocks, so opening a whole batch of blobs is one pass.
* PN keystream: AES-128 used as a CTR block function on counter blocks
  ``(frame_ctr << 64) | block_idx`` (16-byte big-endian), sub-key =
  BLAKE2s(prng_key, digest_size=16, person=b"EchoSeal"); bytes -> bits
  MSB-first.  AES runs as the classic T-table formulation vectorised over
  all blocks, so a verifier's whole PN table is one numpy pass.
"""
from __future__ import annotations

import hashlib
import hmac
import secrets
from functools import lru_cache

import numpy as np

_KDF_INFO = b"EchoSeal:KDF:v1"
_PN_PERSON = b"EchoSeal"


class InvalidTag(Exception):
    """AEAD authentication failed."""


def hkdf_sha256(ikm: bytes, length: int, info: bytes) -> bytes:
    """RFC 5869 extract-and-expand with SHA-256 and no salt (32 zeros)."""
    prk = hmac.new(bytes(32), ikm, hashlib.sha256).digest()
    okm, block = b"", b""
    for i in range(1, -(-length // 32) + 1):
        block = hmac.new(prk, block + info + bytes([i]), hashlib.sha256).digest()
        okm += block
    return okm[:length]


def derive_subkeys(master_key: bytes) -> tuple[bytes, bytes]:
    """HKDF split of the master key into (aead_key, prng_key)."""
    if len(master_key) != 32:
        raise ValueError("master_key must be 32 bytes (256 bit)")
    okm = hkdf_sha256(master_key, 64, _KDF_INFO)
    return okm[:32], okm[32:]


# ======================================================================
# AES-128 (FIPS-197), encryption only, vectorised over blocks
# ======================================================================
def _xtime(b: int) -> int:
    return ((b << 1) ^ (0x1B if b & 0x80 else 0)) & 0xFF


def _rotl8(v: int, s: int) -> int:
    return ((v << s) | (v >> (8 - s))) & 0xFF


@lru_cache(maxsize=1)
def _aes_tables() -> tuple[np.ndarray, tuple[np.ndarray, ...]]:
    """(S-box (256,) uint32, (Te0, Te1, Te2, Te3) (256,) uint32)."""
    sbox = [0] * 256
    p = q = 1
    while True:                       # walk GF(2^8)* by the generator 3
        p ^= _xtime(p)
        q ^= q << 1
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        sbox[p] = (q ^ _rotl8(q, 1) ^ _rotl8(q, 2) ^ _rotl8(q, 3)
                   ^ _rotl8(q, 4) ^ 0x63)
        if p == 1:
            break
    sbox[0] = 0x63
    te0 = [(_xtime(s) << 24) | (s << 16) | (s << 8) | (_xtime(s) ^ s)
           for s in sbox]
    te0 = np.array(te0, dtype=np.uint32)
    tes = tuple(te0 if k == 0 else (te0 >> np.uint32(8 * k))
                | (te0 << np.uint32(32 - 8 * k)) for k in range(4))
    return np.array(sbox, dtype=np.uint32), tes


def _aes128_round_keys(key: bytes) -> np.ndarray:
    """(44,) uint32 expanded key schedule (big-endian words)."""
    sbox = _aes_tables()[0]
    w = [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = ((int(sbox[t >> 24]) << 24) | (int(sbox[(t >> 16) & 0xFF]) << 16)
                 | (int(sbox[(t >> 8) & 0xFF]) << 8) | int(sbox[t & 0xFF]))
            t ^= rcon << 24
            rcon = _xtime(rcon)
        w.append(w[i - 4] ^ t)
    return np.array(w, dtype=np.uint32)


def aes128_encrypt_blocks(round_keys: np.ndarray,
                          blocks: np.ndarray) -> np.ndarray:
    """ECB-encrypt (n, 16) uint8 blocks -> (n, 16) uint8."""
    sbox, (t0, t1, t2, t3) = _aes_tables()
    rk = round_keys
    s = np.ascontiguousarray(blocks, dtype=np.uint8).view(">u4").astype(
        np.uint32)
    s = [s[:, i] ^ rk[i] for i in range(4)]
    m = np.uint32(0xFF)
    for r in range(1, 10):
        s = [t0[s[i] >> 24] ^ t1[(s[(i + 1) % 4] >> 16) & m]
             ^ t2[(s[(i + 2) % 4] >> 8) & m] ^ t3[s[(i + 3) % 4] & m]
             ^ rk[4 * r + i] for i in range(4)]
    out = np.stack(
        [((sbox[s[i] >> 24] << 24) | (sbox[(s[(i + 1) % 4] >> 16) & m] << 16)
          | (sbox[(s[(i + 2) % 4] >> 8) & m] << 8) | sbox[s[(i + 3) % 4] & m])
         ^ rk[40 + i] for i in range(4)], axis=1)
    return out.astype(">u4").view(np.uint8).reshape(-1, 16)


class PnStream:
    """Deterministic AES-128-ECB-in-CTR-layout pseudo-random bit stream.

    The per-frame counter space reserves 2**64 blocks per frame counter, so
    streams for different frames never collide.  The whole counter-block
    buffer for a batch of frames is encrypted in one vectorised pass.
    """

    def __init__(self, prng_key: bytes) -> None:
        sub_key = hashlib.blake2s(
            prng_key, digest_size=16, person=_PN_PERSON
        ).digest()
        self._rk = _aes128_round_keys(sub_key)

    def block_bytes(self, frame_ctrs: np.ndarray, n_bytes: int) -> np.ndarray:
        """Return a (len(frame_ctrs), n_bytes) uint8 array of keystream."""
        ctrs = np.asarray(frame_ctrs, dtype=np.uint64).ravel()
        n_blocks = (n_bytes + 15) // 16
        # counter block = 16-byte big-endian of (ctr << 64) | blk
        buf = np.zeros((ctrs.size, n_blocks, 16), dtype=np.uint8)
        buf[:, :, :8] = ctrs.astype(">u8").view(np.uint8).reshape(
            ctrs.size, 1, 8)
        buf[:, :, 8:] = np.arange(n_blocks, dtype=">u8").view(
            np.uint8).reshape(1, n_blocks, 8)
        ks = aes128_encrypt_blocks(self._rk, buf.reshape(-1, 16))
        return ks.reshape(ctrs.size, n_blocks * 16)[:, :n_bytes]

    def bits(self, frame_ctr: int, n_bits: int) -> np.ndarray:
        """PN bits {0,1} uint8 for one frame (MSB-first per byte)."""
        return self.bits_batch(np.array([frame_ctr]), n_bits)[0]

    def bits_batch(self, frame_ctrs: np.ndarray, n_bits: int) -> np.ndarray:
        """PN bits for many frames at once: (len(frame_ctrs), n_bits) uint8."""
        raw = self.block_bytes(frame_ctrs, (n_bits + 7) // 8)
        return np.unpackbits(raw, axis=1)[:, :n_bits]


# ======================================================================
# ChaCha20-Poly1305 (RFC 8439)
# ======================================================================
_SIGMA = np.frombuffer(b"expand 32-byte k", dtype="<u4").astype(np.uint32)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter_rounds(a, b, c, d):
    """Four independent quarter rounds at once (rows of (4, n) arrays)."""
    a += b
    d = _rotl(d ^ a, 16)
    c += d
    b = _rotl(b ^ c, 12)
    a += b
    d = _rotl(d ^ a, 8)
    c += d
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def chacha20_blocks(key: bytes, nonces: np.ndarray,
                    counters: np.ndarray) -> np.ndarray:
    """(n, 12) uint8 nonces + (n,) block counters -> (n, 64) uint8 keystream."""
    n = counters.shape[0]
    init = np.empty((16, n), dtype=np.uint32)
    init[0:4] = _SIGMA[:, None]
    init[4:12] = np.frombuffer(key, dtype="<u4").astype(np.uint32)[:, None]
    init[12] = np.asarray(counters, dtype=np.uint32)
    init[13:16] = np.ascontiguousarray(nonces, dtype=np.uint8).view(
        "<u4").astype(np.uint32).T
    a, b, c, d = (init[0:4].copy(), init[4:8].copy(),
                  init[8:12].copy(), init[12:16].copy())
    for _ in range(10):
        a, b, c, d = _quarter_rounds(a, b, c, d)            # column round
        b, c, d = np.roll(b, -1, 0), np.roll(c, -2, 0), np.roll(d, -3, 0)
        a, b, c, d = _quarter_rounds(a, b, c, d)            # diagonal round
        b, c, d = np.roll(b, 1, 0), np.roll(c, 2, 0), np.roll(d, 3, 0)
    out = np.concatenate([a, b, c, d]) + init
    return np.ascontiguousarray(out.T).astype("<u4").view(np.uint8)


def _poly1305(otk: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(otk[:16], "little") & \
        0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(otk[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        acc = (acc + int.from_bytes(msg[i:i + 16] + b"\x01", "little")) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _mac_data(ct: bytes) -> bytes:
    """AAD-less RFC 8439 MAC input: ct || pad16 || le64(0) || le64(len)."""
    return (ct + bytes(-len(ct) % 16) + bytes(8)
            + len(ct).to_bytes(8, "little"))


class ChaCha20Poly1305:
    """IETF ChaCha20-Poly1305 AEAD with empty associated data."""

    def __init__(self, key: bytes) -> None:
        if len(key) != 32:
            raise ValueError("ChaCha20-Poly1305 key must be 32 bytes")
        self._key = key

    def _keystreams(self, nonces: list[bytes], lengths: list[int]):
        """Per message: (one-time Poly1305 key, keystream of ``length``)."""
        n_blk = [1 + -(-ln // 64) for ln in lengths]   # block 0 = MAC key
        nonce_rows = np.frombuffer(b"".join(
            nc * k for nc, k in zip(nonces, n_blk)), np.uint8).reshape(-1, 12)
        ctrs = np.concatenate([np.arange(k) for k in n_blk]) if n_blk else \
            np.zeros(0, np.int64)
        ks = chacha20_blocks(self._key, nonce_rows, ctrs).reshape(-1)
        out, pos = [], 0
        for k, ln in zip(n_blk, lengths):
            blk = ks[pos:pos + 64 * k].tobytes()
            out.append((blk[:32], blk[64:64 + ln]))
            pos += 64 * k
        return out

    def encrypt_many(self, nonces: list[bytes],
                     plaintexts: list[bytes]) -> list[bytes]:
        """ciphertext || tag for each (nonce, plaintext) pair."""
        out = []
        for (otk, ks), pt in zip(
                self._keystreams(nonces, [len(p) for p in plaintexts]),
                plaintexts):
            ct = (np.frombuffer(pt, np.uint8)
                  ^ np.frombuffer(ks, np.uint8)).tobytes()
            out.append(ct + _poly1305(otk, _mac_data(ct)))
        return out

    def decrypt_many(self, nonces: list[bytes],
                     data: list[bytes]) -> list[bytes | None]:
        """Plaintext, or None where the tag does not authenticate."""
        lengths = [max(len(d) - 16, 0) for d in data]
        out: list[bytes | None] = []
        for (otk, ks), d in zip(self._keystreams(nonces, lengths), data):
            ct, tag = d[:-16], d[-16:]
            if len(d) < 16 or not hmac.compare_digest(
                    _poly1305(otk, _mac_data(ct)), tag):
                out.append(None)
                continue
            out.append((np.frombuffer(ct, np.uint8)
                        ^ np.frombuffer(ks, np.uint8)).tobytes())
        return out


class SecureChannel:
    """AEAD seal/open plus the PN-bit facade (reference crypto.py:12-48)."""

    def __init__(self, master_key: bytes) -> None:
        aead_key, prng_key = derive_subkeys(master_key)
        self._aead = ChaCha20Poly1305(aead_key)
        self._pn = PnStream(prng_key)

    # ---------------------------------------------------------------- AEAD
    def seal(self, plaintext: bytes) -> bytes:
        """nonce(12) || ciphertext || tag(16)."""
        return self.seal_many([plaintext])[0]

    def seal_many(self, plaintexts: list[bytes],
                  nonces: list[bytes] | None = None) -> list[bytes]:
        """``seal`` for many plaintexts in one keystream pass.

        ``nonces`` (12 bytes each) default to fresh random ones; give them
        only to make reproducible test data, never reuse one under a key.
        """
        if nonces is None:
            nonces = [secrets.token_bytes(12) for _ in plaintexts]
        return [nc + body for nc, body in
                zip(nonces, self._aead.encrypt_many(nonces, plaintexts))]

    def open(self, blob: bytes) -> bytes:
        """Inverse of :meth:`seal`; raises on authentication failure."""
        if len(blob) < 12 + 16:
            raise ValueError("ciphertext too short")
        plain = self._aead.decrypt_many([blob[:12]], [blob[12:]])[0]
        if plain is None:
            raise InvalidTag("AEAD tag mismatch")
        return plain

    def open_any_layout(self, blob: bytes) -> tuple[bytes | None, str | None]:
        """Try nonce-front then nonce-tail AEAD layouts (detector.py:418-448)."""
        return self.open_any_layout_many([blob])[0]

    def open_any_layout_many(self, blobs: list[bytes]
                             ) -> list[tuple[bytes | None, str | None]]:
        """``open_any_layout`` for many blobs, one keystream pass per layout."""
        out: list[tuple[bytes | None, str | None]] = [(None, None)] * len(blobs)
        todo = [i for i, b in enumerate(blobs) if len(b) >= 12]
        for layout, split in (("nonce-front", lambda b: (b[:12], b[12:])),
                              ("nonce-tail", lambda b: (b[-12:], b[:-12]))):
            if not todo:
                break
            parts = [split(blobs[i]) for i in todo]
            plains = self._aead.decrypt_many([p[0] for p in parts],
                                             [p[1] for p in parts])
            for i, plain in zip(todo, plains):
                if plain is not None:
                    out[i] = (plain, layout)
            todo = [i for i, plain in zip(todo, plains) if plain is None]
        return out

    # ------------------------------------------------------------------ PN
    def pn_bits(self, frame_ctr: int, n_bits: int) -> np.ndarray:
        return self._pn.bits(frame_ctr, n_bits)

    def pn_bits_batch(self, frame_ctrs: np.ndarray, n_bits: int) -> np.ndarray:
        return self._pn.bits_batch(frame_ctrs, n_bits)
