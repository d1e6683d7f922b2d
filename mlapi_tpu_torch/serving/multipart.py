"""Minimal ``multipart/form-data`` parser (RFC 7578).

A copy of ``mlapi_tpu/serving/multipart.py`` (the port imports nothing
of the JAX package). Scope: complete (non-streaming) bodies, which
matches the serving layer's read-the-whole-body model.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


class MultipartError(ValueError):
    """Malformed multipart body or content-type."""


@dataclass(frozen=True)
class Part:
    """One form part; ``filename`` is None for plain fields."""

    name: str
    data: bytes
    filename: str | None = None
    content_type: str | None = None

    def text(self, encoding: str = "utf-8") -> str:
        return self.data.decode(encoding)


_BOUNDARY_RE = re.compile(
    r'multipart/form-data\s*;.*?boundary="?([^";,\s]+)"?', re.IGNORECASE | re.DOTALL
)
_DISPOSITION_NAME = re.compile(r'name="((?:[^"\\]|\\.)*)"|name=([^;\s]+)')
_DISPOSITION_FILENAME = re.compile(r'filename="((?:[^"\\]|\\.)*)"|filename=([^;\s]+)')


def boundary_from_content_type(content_type: str) -> bytes:
    m = _BOUNDARY_RE.match(content_type or "")
    if not m:
        raise MultipartError(
            f"not a multipart/form-data content-type: {content_type!r}"
        )
    return m.group(1).encode("latin-1")


def _first_group(m: re.Match | None) -> str | None:
    if m is None:
        return None
    return m.group(1) if m.group(1) is not None else m.group(2)


def parse_multipart(body: bytes, boundary: bytes) -> list[Part]:
    """Parse a complete multipart body into its parts."""
    delim = b"--" + boundary
    # Body structure: [preamble] delim part (delim part)* delim-- [epilogue]
    chunks = body.split(delim)
    if len(chunks) < 2:
        raise MultipartError("boundary never appears in body")
    parts: list[Part] = []
    # chunks[0] is the preamble; the final chunk starts with b"--".
    closed = False
    for chunk in chunks[1:]:
        if chunk.startswith(b"--"):
            closed = True
            break
        # Each part: CRLF headers CRLF CRLF data CRLF
        if not chunk.startswith(b"\r\n"):
            raise MultipartError("malformed part: missing CRLF after boundary")
        chunk = chunk[2:]
        try:
            header_blob, data = chunk.split(b"\r\n\r\n", 1)
        except ValueError:
            raise MultipartError("malformed part: no header/body separator") from None
        if not data.endswith(b"\r\n"):
            raise MultipartError("malformed part: data not CRLF-terminated")
        data = data[:-2]

        headers: dict[str, str] = {}
        for line in header_blob.split(b"\r\n"):
            if not line:
                continue
            key, _, value = line.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()

        disposition = headers.get("content-disposition", "")
        name = _first_group(_DISPOSITION_NAME.search(disposition))
        if name is None:
            raise MultipartError("part has no field name in Content-Disposition")
        filename = _first_group(_DISPOSITION_FILENAME.search(disposition))
        parts.append(
            Part(
                name=name.replace('\\"', '"'),
                data=data,
                filename=filename.replace('\\"', '"') if filename else None,
                content_type=headers.get("content-type"),
            )
        )
    if not closed:
        raise MultipartError("multipart body not properly terminated")
    return parts
