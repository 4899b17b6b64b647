"""Versioned wire format for live serving sessions: the port's counterpart
of ``repro/region/wire.py``, byte for byte.

``RSES | version | codec | crc32(payload) | compressed msgpack payload``

* the 4-byte magic and one-byte **format version** make foreign or
  future-format payloads fail loudly (``WireFormatError``);
* the one-byte **codec id** records how the payload was compressed (the
  checkpoint codec path: zstd when ``zstandard`` imports, zlib otherwise);
* the **crc32** of the compressed payload catches truncation and bit rot
  before anything is deserialized;
* the payload is msgpack (never pickle), every numpy leaf a ``{dtype,
  shape, data}`` record as in checkpoint shards.

The same session gives the same bytes from either package, and each
package decodes the other's.  That makes the wire the path for a session
between the two packages, in bfloat16 too: the port's sessions carry a
bfloat16 cache leaf as its ``uint16`` bits (numpy has no bfloat16), and
the JAX package would convert a ``uint16`` array by value.  So:

* the encoder writes a ``uint16`` **cache** leaf under the dtype string
  ``"bfloat16"``, with the same bytes, as the JAX package writes its
  ``ml_dtypes`` bfloat16 leaves;
* the decoder reads ``"bfloat16"`` as ``uint16`` bits, without
  ``ml_dtypes``, and the engine's ``insert_session`` views them as the
  target cache's bfloat16;
* every other dtype goes through ``np.frombuffer`` as in the reference.

A ``uint16`` array alone does not say that it holds bfloat16 bits.  The
rule "a ``uint16`` cache leaf is bfloat16" holds because no cache has an
integer leaf: :func:`repro_torch.models.sessions.extract_session`, where
the engine makes every session, raises on a cache leaf that is not
floating point.  The prompt and the extras are not cache leaves and keep
their own dtype strings.

``t_first``/``t_admit`` are wall-clock ``perf_counter`` stamps: meaningful
on the host that wrote them, opaque across hosts.
"""

from __future__ import annotations

import struct
import zlib

import msgpack
import numpy as np

from ..checkpoint.store import (compress, decompress, default_codec,
                                host_leaf, pack_record, unpack_record)
from ..serve.engine import Request, Session

WIRE_MAGIC = b"RSES"
# v1: the original layout.  v2 adds the optional "trace" key, v3 the
# optional "prefilled" key, v4 the optional "delivery" key; each is purely
# additive, so a reader takes every version in WIRE_COMPAT.  Writers always
# emit the current version.
WIRE_VERSION = 4
WIRE_COMPAT = frozenset({1, 2, 3, 4})
_CODEC_IDS = {"zlib": 0, "zstd": 1}
_CODEC_NAMES = {v: k for k, v in _CODEC_IDS.items()}
# magic(4) + version(1) + codec(1) + crc32(4)
_HEADER = struct.Struct(">4sBBI")


class WireFormatError(ValueError):
    """The payload is not a decodable session: wrong magic, unknown
    version or codec, checksum mismatch, or corrupt body."""


def _pack_array(a, uint16_is_bf16: bool = False) -> dict:
    return pack_record(*host_leaf(a, uint16_is_bf16))


def encode_session(sess: Session, codec: str | None = None) -> bytes:
    """Serialize a session for transport.  ``codec`` defaults to the best
    one this build can write (the checkpoint codec path)."""
    codec = codec if codec is not None else default_codec()
    if codec not in _CODEC_IDS:
        raise WireFormatError(f"unknown wire codec {codec!r}")
    req = sess.req
    payload = {
        "req": {
            "rid": int(req.rid),
            "prompt": _pack_array(req.prompt),
            "max_new": int(req.max_new),
            "tenant": req.tenant,
            "extras": {k: _pack_array(v) for k, v in req.extras.items()},
            "out_tokens": [int(t) for t in req.out_tokens],
            "done": bool(req.done),
            "t_first": req.t_first,
            "t_admit": req.t_admit,
        },
        "pos": int(sess.pos),
        "cur_token": int(sess.cur_token),
        "cache": {k: _pack_array(v, uint16_is_bf16=True)
                  for k, v in sess.cache.items()},
    }
    if sess.trace is not None:
        payload["trace"] = sess.trace
    if sess.prefilled is not None:
        payload["prefilled"] = int(sess.prefilled)
    if sess.delivery is not None:
        o, rid, epoch = sess.delivery
        payload["delivery"] = [int(o), int(rid), int(epoch)]
    body = compress(msgpack.packb(payload, use_bin_type=True), codec)
    header = _HEADER.pack(WIRE_MAGIC, WIRE_VERSION, _CODEC_IDS[codec],
                          zlib.crc32(body) & 0xFFFFFFFF)
    return header + body


def wire_header(data: bytes) -> dict:
    """Parse and validate just the header: ``{version, codec, crc,
    nbytes}``."""
    if len(data) < _HEADER.size:
        raise WireFormatError(
            f"payload too short for a session wire header "
            f"({len(data)} < {_HEADER.size} bytes)")
    magic, version, codec_id, crc = _HEADER.unpack_from(data)
    if magic != WIRE_MAGIC:
        raise WireFormatError(
            f"bad magic {magic!r}: not a session wire payload")
    if version not in WIRE_COMPAT:
        # the CRC covers only the body, so a corrupted version byte must
        # fail here, not be decoded under the wrong layout
        raise WireFormatError(
            f"unsupported session wire version {version} "
            f"(this build reads {sorted(WIRE_COMPAT)})")
    codec = _CODEC_NAMES.get(codec_id)
    if codec is None:
        raise WireFormatError(f"unknown wire codec id {codec_id}")
    return {"version": version, "codec": codec, "crc": crc,
            "nbytes": len(data)}


def verify_crc(data: bytes) -> dict:
    """Header check plus body-CRC check, without decoding the body.
    Raises :class:`WireFormatError` on any mismatch; returns the parsed
    header on success."""
    h = wire_header(data)
    if (zlib.crc32(data[_HEADER.size:]) & 0xFFFFFFFF) != h["crc"]:
        raise WireFormatError("session payload checksum mismatch "
                              "(truncated or corrupt)")
    return h


def decode_session(data: bytes) -> Session:
    """Reconstruct a session from :func:`encode_session` bytes (either
    package's).  Every failure raises :class:`WireFormatError`; nothing is
    deserialized from a payload whose checksum does not match.  The
    decoded session carries a new :class:`Request` (cross-boundary
    identity is the ``rid``)."""
    h = verify_crc(data)
    body = data[_HEADER.size:]
    try:
        raw = decompress(body, h["codec"])
        payload = msgpack.unpackb(raw, raw=False, strict_map_key=False)
        r = payload["req"]
        req = Request(rid=r["rid"], prompt=unpack_record(r["prompt"]),
                      max_new=r["max_new"], tenant=r["tenant"],
                      extras={k: unpack_record(v)
                              for k, v in r["extras"].items()},
                      out_tokens=list(r["out_tokens"]), done=r["done"],
                      t_first=r["t_first"], t_admit=r["t_admit"])
        delivery = payload.get("delivery")           # absent pre-v4
        return Session(req=req, pos=payload["pos"],
                       cur_token=payload["cur_token"],
                       cache={k: unpack_record(v)
                              for k, v in payload["cache"].items()},
                       trace=payload.get("trace"),   # absent on v1 payloads
                       prefilled=payload.get("prefilled"),  # absent pre-v3
                       delivery=(tuple(delivery) if delivery is not None
                                 else None))
    except WireFormatError:
        raise
    except RuntimeError as e:
        # codec named in the header but not importable on this build
        raise WireFormatError(str(e)) from e
    except Exception as e:      # zlib/msgpack/shape errors: corrupt body
        raise WireFormatError(
            f"session payload failed to decode ({e})") from e
