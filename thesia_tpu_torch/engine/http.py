"""A small HTTP/1.1 and WebSocket server on the standard library.

The JAX package serves its engine through aiohttp
(``thesia_tpu/engine/service.py:371-419``).  The port's service speaks the
same wire contract with only ``asyncio``: what the engine service and its
viewer use of HTTP, and nothing more.

- Requests: request line, headers, ``Content-Length`` bodies, keep-alive
  (HTTP/1.1 by default, HTTP/1.0 on ``Connection: keep-alive``), an idle
  connection closed after 75 s as aiohttp does.  A body that the handler
  reads whole may hold up to ``MAX_BODY`` bytes (aiohttp's
  ``client_max_size`` of the JAX service), above it the answer is 413; a
  body sent with ``Transfer-Encoding: chunked`` gets 411 (the viewer never
  sends one; aiohttp would read it).
- Responses: JSON as ``json.dumps`` writes it (NaN allowed, like aiohttp's
  ``json_response``), bytes, files of a static directory with
  ``text/javascript`` for ``.js`` (browsers refuse a module script of another
  type), ``..`` refused.
- Multipart uploads: a streaming scan for the boundary; the caller writes the
  part chunk by chunk and never holds the whole body.
- WebSocket (RFC 6455): the ``Sec-WebSocket-Accept`` handshake, unmasked
  server text frames (7-, 16- and 64-bit lengths), masked client frames
  (read and dropped: the events socket only sends), pong for ping, an
  echoed close.
"""

from __future__ import annotations

import asyncio
import base64
import email.message
import email.utils
import hashlib
import html
import http
import json
import logging
import mimetypes
import os
import struct
import urllib.parse
from pathlib import Path

log = logging.getLogger(__name__)

MAX_BODY = 256 * 1024 * 1024
KEEPALIVE_S = 75.0
MAX_HEADERS = 100
# a request body the handler left unread is skipped up to this size to keep
# the connection; a larger one closes it
MAX_SKIP = 1 << 20
WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
WS_MAX_FRAME = 4 * 1024 * 1024  # aiohttp's max_msg_size


class HttpError(Exception):
    """Ends a request with ``status`` and a plain-text body."""

    def __init__(self, status: int, message: str | None = None):
        super().__init__(message or http.HTTPStatus(status).phrase)
        self.status = status


class Response:
    def __init__(self, body: bytes, status: int, content_type: str):
        self.body = body
        self.status = status
        self.content_type = content_type


def json_response(data, status: int = 200) -> Response:
    return Response(json.dumps(data).encode(), status, "application/json; charset=utf-8")


def bytes_response(body: bytes) -> Response:
    return Response(body, 200, "application/octet-stream")


def text_response(status: int, text: str) -> Response:
    return Response(text.encode(), status, "text/plain; charset=utf-8")


class Request:
    """One request: its line and headers are parsed; the body stays on the
    connection until ``read``, ``json`` or ``read_chunk`` takes it."""

    def __init__(self, method: str, target: str, version: str, headers: dict, reader, writer):
        self.method = method
        self.version = version
        self.path = urllib.parse.unquote(urllib.parse.urlsplit(target).path)
        self.headers = headers
        self.reader = reader
        self.writer = writer
        self.chunked = "chunked" in headers.get("transfer-encoding", "").lower()
        try:
            self.content_length = int(headers.get("content-length", "0"))
        except ValueError:
            raise HttpError(400, "invalid Content-Length") from None
        if self.content_length < 0:
            raise HttpError(400, "invalid Content-Length")
        self.remaining = self.content_length
        self._body: bytes | None = None

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn

    @property
    def can_read_body(self) -> bool:
        return self.content_length > 0

    async def read(self) -> bytes:
        """The whole body; 413 above ``MAX_BODY``."""
        if self._body is None:
            if self.content_length > MAX_BODY:
                raise HttpError(413, f"request body of {self.content_length} bytes exceeds "
                                     f"{MAX_BODY}")
            self._body = await self.reader.readexactly(self.remaining)
            self.remaining = 0
        return self._body

    async def json(self):
        """The body parsed as JSON (``json.JSONDecodeError`` or
        ``UnicodeDecodeError`` for a body that is not)."""
        _, _, charset = self.headers.get("content-type", "").lower().partition("charset=")
        charset = charset.split(";")[0].strip().strip('"') or "utf-8"
        return json.loads((await self.read()).decode(charset))

    async def read_chunk(self, size: int = 1 << 16) -> bytes:
        """Up to ``size`` more bytes of the body; b"" at its end."""
        n = min(size, self.remaining)
        if n <= 0:
            return b""
        chunk = await self.reader.read(n)
        if not chunk:
            raise asyncio.IncompleteReadError(chunk, n)
        self.remaining -= len(chunk)
        return chunk


def _head(resp: Response, keep_alive: bool, version: str) -> bytes:
    lines = [f"HTTP/1.1 {resp.status} {http.HTTPStatus(resp.status).phrase}",
             f"Content-Type: {resp.content_type}", f"Content-Length: {len(resp.body)}"]
    lines.append(f"Date: {email.utils.formatdate(usegmt=True)}")
    lines.append("Server: thesia_tpu_torch")
    if not keep_alive:
        lines.append("Connection: close")
    elif version == "HTTP/1.0":
        lines.append("Connection: keep-alive")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class HttpServer:
    """Serves ``handler(request) -> Response | None`` over asyncio streams;
    ``None`` means the handler took the connection over (a WebSocket)."""

    def __init__(self, handler):
        self.handler = handler
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()

    async def start(self, host: str, port: int) -> int:
        """Listen; returns the bound port (``port`` 0 picks a free one)."""
        self._server = await asyncio.start_server(self._connection, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in list(self._conns):
            task.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    async def _connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while await self._one_request(reader, writer):
                pass
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    async def _one_request(self, reader, writer) -> bool:
        """Serve one request; whether the connection stays open."""
        try:
            req = await asyncio.wait_for(_read_request(reader, writer), KEEPALIVE_S)
        except HttpError as e:
            await _write(writer, text_response(e.status, str(e)), False, "HTTP/1.1", False)
            return False
        if req is None:
            return False
        keep = req.keep_alive
        if req.chunked:
            log.warning("%s %s: chunked request body refused with 411", req.method, req.path)
            resp, keep = text_response(411, "Length Required: send a Content-Length body"), False
        else:
            try:
                resp = await self.handler(req)
            except HttpError as e:
                resp = text_response(e.status, f"{e.status}: {e}")
            except (ConnectionError, asyncio.IncompleteReadError):
                raise
            except Exception:
                log.exception("error handling %s %s", req.method, req.path)
                resp = text_response(500, "500 Internal Server Error\n\nServer got itself in trouble")
            if resp is None:
                return False
        if req.remaining:
            if req.remaining > MAX_SKIP:
                keep = False
            else:
                await req.reader.readexactly(req.remaining)
                req.remaining = 0
        await _write(writer, resp, keep, req.version, req.method == "HEAD")
        return keep


async def _read_request(reader, writer) -> Request | None:
    try:
        line = await reader.readuntil(b"\r\n")
    except asyncio.IncompleteReadError as e:
        if e.partial.strip():
            raise HttpError(400, "incomplete request line") from None
        return None  # the client closed an idle connection
    except asyncio.LimitOverrunError:
        raise HttpError(400, "request line too long") from None
    parts = line.decode("latin-1").rstrip("\r\n").split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, "malformed request line")
    headers = {}
    for _ in range(MAX_HEADERS + 1):
        try:
            hline = await reader.readuntil(b"\r\n")
        except asyncio.LimitOverrunError:
            raise HttpError(400, "header line too long") from None
        if hline == b"\r\n":
            return Request(*parts, headers, reader, writer)
        name, sep, value = hline.decode("latin-1").partition(":")
        if not sep or not name.strip():
            raise HttpError(400, "malformed header line")
        headers[name.strip().lower()] = value.strip()
    raise HttpError(400, "too many headers")


async def _write(writer, resp: Response, keep_alive: bool, version: str, head_only: bool) -> None:
    writer.write(_head(resp, keep_alive, version))
    if resp.body and not head_only:
        writer.write(resp.body)
    await writer.drain()


# -- static files --------------------------------------------------------------


def _static_file(root: Path, rel: str) -> Response:
    """The file or directory listing at ``rel`` under ``root`` (blocking)."""
    parts = [p for p in rel.split("/") if p]
    if any(p in (".", "..") or "\\" in p or "\0" in p for p in parts):
        raise HttpError(404)
    path = root.joinpath(*parts)
    try:
        resolved = path.resolve()
        resolved.relative_to(root)
    except (ValueError, OSError, RuntimeError):
        raise HttpError(404) from None
    if resolved.is_dir():
        names = sorted(os.listdir(resolved))
        base = "/" + "/".join(parts)
        items = "".join(
            f'<li><a href="{html.escape(base.rstrip("/") + "/" + n)}">{html.escape(n)}</a></li>\n'
            for n in names)
        page = (f"<html>\n<head>\n<title>Index of {html.escape(base)}</title>\n</head>\n<body>\n"
                f"<h1>Index of {html.escape(base)}</h1>\n<ul>\n{items}</ul>\n</body>\n</html>")
        return Response(page.encode(), 200, "text/html; charset=utf-8")
    if not resolved.is_file():
        raise HttpError(404)
    # .js by name: a module script of another type is refused by browsers
    ctype = ("text/javascript" if resolved.suffix == ".js"
             else mimetypes.guess_type(resolved.name)[0] or "application/octet-stream")
    return Response(resolved.read_bytes(), 200, ctype)


async def static_response(root: str, rel: str) -> Response:
    """A file of the directory ``root`` (404 outside it or for ``..``)."""
    root_path = Path(root).resolve()
    return await asyncio.get_running_loop().run_in_executor(None, _static_file, root_path, rel)


# -- multipart -------------------------------------------------------------------


class MultipartPart:
    """One part of a multipart body, read chunk by chunk up to its boundary."""

    def __init__(self, stream: "MultipartReader", headers: dict):
        self._stream = stream
        msg = email.message.Message()
        msg["content-disposition"] = headers.get("content-disposition", "")
        self.name = msg.get_param("name", header="content-disposition")
        self.filename = msg.get_filename()
        self._done = False

    async def read_chunk(self) -> bytes:
        """The part's next bytes; b"" once its boundary has been reached."""
        if self._done:
            return b""
        s = self._stream
        while True:
            i = s.buf.find(s.delim)
            if i >= 0:
                out = bytes(s.buf[:i])
                del s.buf[:i]
                self._done = True
                return out
            keep = len(s.delim) - 1
            if len(s.buf) > keep:
                out = bytes(s.buf[: len(s.buf) - keep])
                del s.buf[: len(s.buf) - keep]
                return out
            await s.fill()


class MultipartReader:
    """The parts of a ``multipart/*`` request body, streamed (only the first
    part is needed by the upload route)."""

    def __init__(self, req: Request):
        msg = email.message.Message()
        msg["content-type"] = req.headers.get("content-type", "")
        boundary = msg.get_param("boundary")
        if msg.get_content_maintype() != "multipart" or not boundary:
            raise HttpError(400, "expected a multipart body with a boundary")
        self.req = req
        self.delim = b"\r\n--" + str(boundary).encode("latin-1")
        # the first boundary has no CRLF before it: add one
        self.buf = bytearray(b"\r\n")

    async def fill(self) -> None:
        chunk = await self.req.read_chunk()
        if not chunk:
            raise HttpError(400, "multipart body ends inside a part")
        self.buf += chunk

    async def next(self) -> MultipartPart | None:
        """The first part, or None when the body has none."""
        while (i := self.buf.find(self.delim)) < 0 or len(self.buf) < i + len(self.delim) + 2:
            if len(self.buf) > 1 << 16:
                raise HttpError(400, "no multipart boundary in the first 64 KiB")
            await self.fill()
        rest = i + len(self.delim)
        if self.buf[rest : rest + 2] == b"--":
            return None
        while (end := self.buf.find(b"\r\n\r\n", rest)) < 0:
            if len(self.buf) - rest > (1 << 14):
                raise HttpError(400, "multipart part headers too long")
            await self.fill()
        headers = {}
        for hline in bytes(self.buf[rest:end]).decode("utf-8", "replace").split("\r\n"):
            name, sep, value = hline.partition(":")
            if sep:
                headers[name.strip().lower()] = value.strip()
        del self.buf[: end + 4]
        return MultipartPart(self, headers)


# -- WebSocket -------------------------------------------------------------------


class WebSocket:
    """The server side of one WebSocket connection."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.closed = False

    async def send_str(self, text: str) -> None:
        await self._send(0x1, text.encode())

    async def _send(self, opcode: int, payload: bytes) -> None:
        if self.closed and opcode != 0x8:
            raise ConnectionResetError("WebSocket is closed")
        n = len(payload)
        if n < 126:
            head = struct.pack("!BB", 0x80 | opcode, n)
        elif n < 1 << 16:
            head = struct.pack("!BBH", 0x80 | opcode, 126, n)
        else:
            head = struct.pack("!BBQ", 0x80 | opcode, 127, n)
        self.writer.write(head + payload)
        await self.writer.drain()

    async def _frame(self) -> tuple[int, bytes]:
        b0, b1 = await self.reader.readexactly(2)
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", await self.reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await self.reader.readexactly(8))
        if n > WS_MAX_FRAME:
            raise ValueError(f"WebSocket frame of {n} bytes")
        mask = await self.reader.readexactly(4) if b1 & 0x80 else None
        data = await self.reader.readexactly(n)
        if mask:
            data = bytes(b ^ mask[i & 3] for i, b in enumerate(data))
        return b0 & 0x0F, data

    async def serve_until_closed(self) -> None:
        """Read the client's frames until it closes: answer pings, echo the
        close, ignore data (the events socket is server-to-client)."""
        try:
            while True:
                op, data = await self._frame()
                if op == 0x8:
                    await self._send(0x8, data[:2])
                    return
                if op == 0x9:
                    await self._send(0xA, data)
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            return
        finally:
            self.closed = True


async def accept_websocket(req: Request) -> WebSocket:
    """Answer the upgrade handshake of ``req`` (400 when it is none)."""
    key = req.headers.get("sec-websocket-key", "")
    if ("websocket" not in req.headers.get("upgrade", "").lower()
            or "upgrade" not in req.headers.get("connection", "").lower() or not key):
        raise HttpError(400, "No WebSocket UPGRADE hdr")
    accept = base64.b64encode(hashlib.sha1(key.encode() + WS_GUID).digest()).decode()
    req.writer.write((
        "HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\nConnection: upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept}\r\nServer: thesia_tpu_torch\r\n\r\n").encode())
    await req.writer.drain()
    return WebSocket(req.reader, req.writer)
