"""Vendored pure-Python MySQL driver (client/server protocol 4.1, DB-API 2.0).

Counterpart of ``predictionio_tpu/data/storage/mywire.py``, byte for
byte on the wire. Like :mod:`~predictionio_tpu_torch.data.storage.pgwire`
for PostgreSQL, this is the ``mysql`` backend's driver where no
``pymysql``/``MySQLdb`` is installed: a minimal DB-API driver speaking
the MySQL client/server protocol over a plain socket, implementing
exactly what :mod:`~predictionio_tpu_torch.data.storage.sql_common` +
:class:`~predictionio_tpu_torch.data.storage.mysql.MySQLDialect` need:

* handshake v10 + ``mysql_native_password`` auth (incl. the
  AuthSwitchRequest path a real server takes when its default is
  ``caching_sha2_password``)
* ``COM_QUERY`` with the text protocol and client-side parameter
  interpolation (``format``/``%s`` paramstyle, like pymysql; a ``%s``
  inside a quoted literal is text)
* text-format result decoding by column type / charset
* explicit transactions (lazy BEGIN; ``commit``/``rollback``)
* the DB-API exception hierarchy mapped from server error codes

Not implemented (not needed here): prepared statements (binary
protocol), compression, TLS, ``caching_sha2_password`` itself,
multi-statement/multi-resultset.
"""

from __future__ import annotations

import hashlib
import socket
import struct
from typing import Any, Iterable, Sequence

apilevel = "2.0"
threadsafety = 1  # module-level sharing only; one connection per thread
paramstyle = "format"

# -- capability flags (protocol constants) ----------------------------------
CLIENT_LONG_PASSWORD = 0x00000001
CLIENT_CONNECT_WITH_DB = 0x00000008
CLIENT_PROTOCOL_41 = 0x00000200
CLIENT_TRANSACTIONS = 0x00002000
CLIENT_SECURE_CONNECTION = 0x00008000
CLIENT_PLUGIN_AUTH = 0x00080000

#: what this driver speaks (CONNECT_WITH_DB added when a db is named)
BASE_CAPABILITIES = (
    CLIENT_LONG_PASSWORD
    | CLIENT_PROTOCOL_41
    | CLIENT_TRANSACTIONS
    | CLIENT_SECURE_CONNECTION
    | CLIENT_PLUGIN_AUTH
)

COM_QUIT = 0x01
COM_QUERY = 0x03
COM_PING = 0x0E

#: sanity ceiling on one protocol packet payload (the wire maximum)
_MAX_PACKET = 0xFFFFFF

# column type codes (text protocol decode)
_INT_TYPES = {1, 2, 3, 8, 9, 13}  # TINY/SHORT/LONG/LONGLONG/INT24/YEAR
_FLOAT_TYPES = {0, 4, 5, 246}  # DECIMAL/FLOAT/DOUBLE/NEWDECIMAL
_BLOB_TYPES = {249, 250, 251, 252}  # TINY/MEDIUM/LONG/BLOB
_BINARY_CHARSET = 63


# -- DB-API exceptions ------------------------------------------------------


class Error(Exception):
    """Base DB-API error; carries the server errno when known."""

    def __init__(self, msg: str, errno: int | None = None):
        super().__init__(msg)
        self.errno = errno


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class OperationalError(DatabaseError):
    pass


class IntegrityError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class InternalError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


Warning = type("Warning", (Exception,), {})  # noqa: A001 - DB-API name
DataError = type("DataError", (DatabaseError,), {})

#: duplicate-key, NOT NULL (1048), foreign-key (1452) and CHECK (3819)
#: violations → IntegrityError
_INTEGRITY_ERRNOS = {1022, 1048, 1062, 1169, 1452, 1557, 1586, 1761, 1762,
                     1859, 3819}
#: syntax / unknown object family → ProgrammingError (pymysql parity:
#: 1146 no-such-table is a ProgrammingError there too)
_PROGRAMMING_ERRNOS = {1054, 1061, 1064, 1103, 1146, 1148}


def _error_for(errno: int, msg: str) -> DatabaseError:
    text = f"({errno}, {msg!r})"
    if errno in _INTEGRITY_ERRNOS:
        return IntegrityError(text, errno)
    if errno in _PROGRAMMING_ERRNOS:
        return ProgrammingError(text, errno)
    return OperationalError(text, errno)


# -- mysql_native_password scramble -----------------------------------------


def native_password_scramble(password: str, salt: bytes) -> bytes:
    """``SHA1(password) XOR SHA1(salt + SHA1(SHA1(password)))`` — the
    documented mysql_native_password response (empty password → empty
    response)."""
    if not password:
        return b""
    pw = password.encode("utf-8")
    h1 = hashlib.sha1(pw).digest()
    h2 = hashlib.sha1(h1).digest()
    mask = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, mask))


# -- literal quoting (client-side interpolation, %s paramstyle) -------------


def quote(value: Any) -> str:
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (bytes, bytearray, memoryview)):
        # hex literal: identical meaning in MySQL and sqlite (minimysql)
        return f"x'{bytes(value).hex()}'"
    if isinstance(value, str):
        # backslash is an escape character in MySQL's default sql_mode;
        # doubling the quote is understood in every mode. NUL must be
        # escaped (raw 0x00 ends the statement for most servers; note
        # the sqlite-backed minimysql cannot store NUL either way)
        return "'" + (
            value.replace("\\", "\\\\")
            .replace("\x00", "\\0")
            .replace("'", "''")
        ) + "'"
    raise ProgrammingError(f"cannot adapt parameter of type {type(value)}")


def split_placeholders(sql: str) -> list[str]:
    """Split ``sql`` on the ``%s`` placeholders that stand outside its
    quoted literals and identifiers (``'...'``, ``"..."``, backticks;
    backslash escapes and doubled quotes inside them). A ``%s`` inside
    a literal is text, not a placeholder (ROADMAP.md §3: the JAX
    driver splits on every ``%s``)."""
    parts: list[str] = []
    start = i = 0
    n = len(sql)
    while i < n:
        ch = sql[i]
        if ch in "'\"`":
            i += 1
            while i < n:
                c = sql[i]
                if c == "\\" and ch != "`":
                    i += 2
                elif c == ch:
                    if sql[i + 1:i + 2] == ch:  # doubled quote
                        i += 2
                    else:
                        i += 1
                        break
                else:
                    i += 1
        elif sql.startswith("%s", i):
            parts.append(sql[start:i])
            i += 2
            start = i
        else:
            i += 1
    parts.append(sql[start:])
    return parts


def interpolate(sql: str, params: Sequence[Any]) -> str:
    if not params:
        return sql
    parts = split_placeholders(sql)
    if len(parts) != len(params) + 1:
        raise ProgrammingError(
            f"statement has {len(parts) - 1} placeholders but "
            f"{len(params)} parameters were supplied"
        )
    out = [parts[0]]
    for part, p in zip(parts[1:], params):
        out.append(quote(p))
        out.append(part)
    return "".join(out)


# -- length-encoded primitives ----------------------------------------------


def lenenc_int(value: int) -> bytes:
    if value < 0xFB:
        return bytes([value])
    if value < 1 << 16:
        return b"\xfc" + struct.pack("<H", value)
    if value < 1 << 24:
        return b"\xfd" + struct.pack("<I", value)[:3]
    return b"\xfe" + struct.pack("<Q", value)


def read_lenenc_int(buf: bytes, pos: int) -> tuple[int, int]:
    first = buf[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return (
            struct.unpack_from("<I", buf[pos + 1:pos + 4] + b"\x00")[0],
            pos + 4,
        )
    if first == 0xFE:
        return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9
    raise InterfaceError(f"invalid length-encoded integer 0x{first:02x}")


def read_lenenc_bytes(buf: bytes, pos: int) -> tuple[bytes | None, int]:
    if buf[pos] == 0xFB:  # NULL marker (text resultset rows)
        return None, pos + 1
    n, pos = read_lenenc_int(buf, pos)
    return buf[pos:pos + n], pos + n


# -- packet plumbing --------------------------------------------------------


class _Packets:
    """Framed reads/writes: 3-byte LE length + 1-byte sequence id."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""
        self.seq = 0

    def send(self, payload: bytes) -> None:
        # payloads >= 16 MiB - 1 are split: each full 0xFFFFFF chunk is
        # followed by more, terminated by a short (possibly empty) chunk
        out = []
        offset = 0
        while True:
            chunk = payload[offset:offset + _MAX_PACKET]
            out.append(
                struct.pack("<I", len(chunk))[:3]
                + bytes([self.seq])
                + chunk
            )
            self.seq = (self.seq + 1) & 0xFF
            offset += len(chunk)
            if len(chunk) < _MAX_PACKET:
                break
        self._sock.sendall(b"".join(out))

    def _read_exact(self, n: int) -> bytes:
        # chunks are joined once (growing one bytes object chunk by
        # chunk is quadratic in a 16 MiB packet; ROADMAP.md §3)
        buf = self._buf
        if len(buf) < n:
            parts, have = [buf], len(buf)
            while have < n:
                chunk = self._sock.recv(min(max(n - have, 65536), 1 << 20))
                if not chunk:
                    raise OperationalError("server closed the connection")
                parts.append(chunk)
                have += len(chunk)
            buf = b"".join(parts)
        out, self._buf = buf[:n], buf[n:]
        return out

    def recv(self) -> bytes:
        # reassemble split packets: a 0xFFFFFF-length packet continues
        # in the next one, until a short (possibly empty) packet ends it
        parts = []
        while True:
            header = self._read_exact(4)
            length = header[0] | header[1] << 8 | header[2] << 16
            self.seq = (header[3] + 1) & 0xFF
            parts.append(self._read_exact(length))
            if length < _MAX_PACKET:
                return b"".join(parts)


def _parse_err(payload: bytes) -> DatabaseError:
    # 0xff, errno (2 LE), '#' marker, 5-byte sqlstate, message
    (errno,) = struct.unpack_from("<H", payload, 1)
    rest = payload[3:]
    if rest[:1] == b"#":
        rest = rest[6:]  # skip marker + sqlstate
    return _error_for(errno, rest.decode("utf-8", "replace"))


def _parse_ok(payload: bytes) -> tuple[int, int]:
    """OK packet → (affected_rows, last_insert_id)."""
    pos = 1
    affected, pos = read_lenenc_int(payload, pos)
    last_id, pos = read_lenenc_int(payload, pos)
    return affected, last_id


def _is_eof(payload: bytes) -> bool:
    return payload[:1] == b"\xfe" and len(payload) < 9


# -- connection -------------------------------------------------------------


class Connection:
    def __init__(
        self,
        host: str = "localhost",
        port: int = 3306,
        database: str = "",
        user: str = "root",
        password: str = "",
        connect_timeout: float = 10.0,
    ):
        self._closed = False
        self._in_tx = False
        try:
            sock = socket.create_connection(
                (host, port), timeout=connect_timeout
            )
        except OSError as exc:
            self._closed = True
            raise OperationalError(
                f"cannot connect to {host}:{port}: {exc}"
            ) from exc
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._packets = _Packets(sock)
        self._sock = sock
        try:
            self._handshake(database, user, password)
        except BaseException:
            self.close()
            raise

    # -- session startup ---------------------------------------------------
    def _handshake(self, database: str, user: str, password: str) -> None:
        greeting = self._packets.recv()
        if greeting[:1] == b"\xff":
            raise _parse_err(greeting)
        if greeting[0] != 10:
            raise NotSupportedError(
                f"unsupported handshake protocol {greeting[0]}"
            )
        pos = greeting.index(b"\x00", 1) + 1  # server version string
        pos += 4  # connection id
        salt = greeting[pos:pos + 8]
        pos += 8 + 1  # auth-data part 1 + filler
        (cap_low,) = struct.unpack_from("<H", greeting, pos)
        pos += 2
        capabilities = cap_low
        plugin = "mysql_native_password"
        if pos < len(greeting):
            pos += 1 + 2  # charset, status
            (cap_high,) = struct.unpack_from("<H", greeting, pos)
            capabilities |= cap_high << 16
            pos += 2
            auth_len = greeting[pos]
            pos += 1 + 10  # auth data length + reserved
            if capabilities & CLIENT_SECURE_CONNECTION:
                take = max(13, auth_len - 8)
                salt += greeting[pos:pos + take].rstrip(b"\x00")[:12]
                pos += take
            if capabilities & CLIENT_PLUGIN_AUTH:
                end = greeting.index(b"\x00", pos)
                plugin = greeting[pos:end].decode("ascii")
        if not capabilities & CLIENT_PROTOCOL_41:
            raise NotSupportedError("server does not speak protocol 4.1")
        if plugin != "mysql_native_password":
            # respond with native anyway; servers defaulting to
            # caching_sha2 answer with an AuthSwitchRequest we honor
            plugin = "mysql_native_password"
        auth = native_password_scramble(password, salt)
        caps = BASE_CAPABILITIES | (
            CLIENT_CONNECT_WITH_DB if database else 0
        )
        response = (
            struct.pack("<I", caps)
            + struct.pack("<I", _MAX_PACKET)
            + bytes([33])  # utf8_general_ci
            + b"\x00" * 23
            + user.encode("utf-8") + b"\x00"
            + bytes([len(auth)]) + auth
        )
        if database:
            response += database.encode("utf-8") + b"\x00"
        response += b"mysql_native_password\x00"
        self._packets.send(response)
        reply = self._packets.recv()
        if reply[:1] == b"\xfe" and len(reply) > 1:
            # AuthSwitchRequest: plugin name NUL, then fresh salt
            end = reply.index(b"\x00", 1)
            new_plugin = reply[1:end].decode("ascii")
            if new_plugin != "mysql_native_password":
                raise NotSupportedError(
                    f"server requires unsupported auth plugin "
                    f"{new_plugin!r}"
                )
            new_salt = reply[end + 1:].rstrip(b"\x00")
            self._packets.send(
                native_password_scramble(password, new_salt)
            )
            reply = self._packets.recv()
        if reply[:1] == b"\xff":
            raise _parse_err(reply)
        if reply[:1] not in (b"\x00", b"\xfe"):
            raise InterfaceError("unexpected authentication reply")

    # -- query execution ---------------------------------------------------
    def _query(self, sql: str) -> tuple[list, list, int, int]:
        """Run one COM_QUERY; returns (columns, rows, rowcount, lastrowid).

        ``columns`` is ``[(name, type, charset), ...]`` for resultsets,
        ``[]`` for DML.
        """
        if self._closed:
            raise InterfaceError("connection is closed")
        self._packets.seq = 0
        self._packets.send(bytes([COM_QUERY]) + sql.encode("utf-8"))
        first = self._packets.recv()
        if first[:1] == b"\xff":
            raise _parse_err(first)
        if first[:1] == b"\x00":  # OK: DML, no resultset
            affected, last_id = _parse_ok(first)
            return [], [], affected, last_id
        ncols, _ = read_lenenc_int(first, 0)
        columns: list[tuple[str, int, int]] = []
        for _ in range(ncols):
            columns.append(self._parse_column(self._packets.recv()))
        eof = self._packets.recv()
        if not _is_eof(eof):
            raise InterfaceError("expected EOF after column definitions")
        rows: list[tuple] = []
        while True:
            payload = self._packets.recv()
            if _is_eof(payload):
                return columns, rows, len(rows), 0
            if payload[:1] == b"\xff":
                raise _parse_err(payload)
            pos, vals = 0, []
            for _name, ctype, charset in columns:
                raw, pos = read_lenenc_bytes(payload, pos)
                vals.append(self._decode(raw, ctype, charset))
            rows.append(tuple(vals))

    @staticmethod
    def _parse_column(payload: bytes) -> tuple[str, int, int]:
        pos = 0
        for _ in range(4):  # catalog, schema, table, org_table
            _skip, pos = read_lenenc_bytes(payload, pos)
        name, pos = read_lenenc_bytes(payload, pos)
        _org, pos = read_lenenc_bytes(payload, pos)
        pos += 1  # lenenc length of the fixed fields (0x0c)
        (charset,) = struct.unpack_from("<H", payload, pos)
        pos += 2 + 4  # charset + column length
        ctype = payload[pos]
        return (name or b"").decode("utf-8"), ctype, charset

    @staticmethod
    def _decode(raw: bytes | None, ctype: int, charset: int) -> Any:
        if raw is None:
            return None
        if ctype in _INT_TYPES:
            return int(raw)
        if ctype in _FLOAT_TYPES:
            return float(raw)
        if ctype in _BLOB_TYPES and charset == _BINARY_CHARSET:
            return raw
        return raw.decode("utf-8")

    def _exec_tx(self, sql: str) -> tuple[list, list, int, int]:
        if not self._in_tx:
            self._query("BEGIN")
            self._in_tx = True
        return self._query(sql)

    # -- DB-API surface ----------------------------------------------------
    def cursor(self) -> "Cursor":
        return Cursor(self)

    def commit(self) -> None:
        if self._in_tx:
            self._query("COMMIT")
            self._in_tx = False

    def rollback(self) -> None:
        if self._in_tx:
            try:
                self._query("ROLLBACK")
            finally:
                self._in_tx = False

    def ping(self) -> None:
        self._packets.seq = 0
        self._packets.send(bytes([COM_PING]))
        reply = self._packets.recv()
        if reply[:1] != b"\x00":
            raise OperationalError("ping failed")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._packets.seq = 0
                self._packets.send(bytes([COM_QUIT]))
            except (OSError, Error):
                pass
            self._sock.close()


class Cursor:
    arraysize = 1

    def __init__(self, conn: Connection):
        self._conn = conn
        self.description: list | None = None
        self.rowcount = -1
        self.lastrowid = 0
        self._rows: list[tuple] = []
        self._idx = 0

    def execute(self, sql: str, params: Sequence[Any] = ()) -> "Cursor":
        columns, rows, rowcount, lastrowid = self._conn._exec_tx(
            interpolate(sql, tuple(params))
        )
        self.description = (
            [
                (name, ctype, None, None, None, None, None)
                for name, ctype, _cs in columns
            ]
            or None
        )
        self._rows, self._idx = rows, 0
        self.rowcount, self.lastrowid = rowcount, lastrowid
        return self

    def executemany(
        self, sql: str, seq_of_params: Iterable[Sequence[Any]]
    ) -> "Cursor":
        total = 0
        for params in seq_of_params:
            self.execute(sql, params)
            if self.rowcount > 0:
                total += self.rowcount
        self.description = None
        self._rows, self._idx = [], 0
        self.rowcount = total
        return self

    def fetchone(self):
        if self._idx >= len(self._rows):
            return None
        row = self._rows[self._idx]
        self._idx += 1
        return row

    def fetchmany(self, size: int | None = None):
        size = size or self.arraysize
        out = self._rows[self._idx:self._idx + size]
        self._idx += len(out)
        return out

    def fetchall(self):
        out = self._rows[self._idx:]
        self._idx = len(self._rows)
        return out

    def close(self) -> None:
        self._rows = []

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row


def connect(**kwargs) -> Connection:
    return Connection(**kwargs)
