"""Vendored pure-Python PostgreSQL driver (wire protocol v3, DB-API 2.0).

Counterpart of ``predictionio_tpu/data/storage/pgwire.py``, byte for
byte on the wire. Where no ``psycopg2`` or ``pg8000`` is installed, this
is the driver of the ``postgres`` backend: a minimal DB-API driver
speaking the PostgreSQL frontend/backend protocol v3 over a plain
socket, implementing exactly what
:mod:`predictionio_tpu_torch.data.storage.sql_common` needs:

* startup + auth: trust, cleartext password, MD5, SCRAM-SHA-256
* the simple query protocol with client-side parameter interpolation
  (``format``/``%s`` paramstyle, like psycopg2)
* text-format result decoding by type OID (ints, floats, bool, bytea)
* explicit transactions (lazy BEGIN; ``commit``/``rollback``)
* the DB-API exception hierarchy mapped from SQLSTATE classes

Not implemented (not needed here): extended query protocol, COPY,
LISTEN/NOTIFY, SSL negotiation, binary format.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct
from typing import Any, Iterable, Sequence

apilevel = "2.0"
threadsafety = 1  # module-level sharing only; one connection per thread
paramstyle = "format"


# -- DB-API exceptions ------------------------------------------------------


class Error(Exception):
    """Base DB-API error; carries the server's SQLSTATE when known."""

    def __init__(self, msg: str, sqlstate: str | None = None):
        super().__init__(msg)
        self.sqlstate = sqlstate


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


def _error_for(sqlstate: str, msg: str) -> DatabaseError:
    """Map an SQLSTATE class to the DB-API exception hierarchy
    (class 23 integrity, 42 syntax/undefined-object, else operational)."""
    if sqlstate.startswith("23"):
        return IntegrityError(msg, sqlstate)
    if sqlstate.startswith(("42", "26")):
        return ProgrammingError(msg, sqlstate)
    return OperationalError(msg, sqlstate)


# -- literal quoting (client-side interpolation, %s paramstyle) -------------


def quote(value: Any) -> str:
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "TRUE" if value else "FALSE"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return f"'\\x{bytes(value).hex()}'::bytea"
    if isinstance(value, str):
        # standard_conforming_strings=on (server default since 9.1):
        # backslash is literal, only the quote needs doubling
        return "'" + value.replace("'", "''") + "'"
    raise ProgrammingError(f"cannot adapt parameter of type {type(value)}")


def interpolate(sql: str, params: Sequence[Any]) -> str:
    if not params:
        return sql
    parts = sql.split("%s")
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


# -- text-format value decoding by OID --------------------------------------

_INT_OIDS = {20, 21, 23, 26, 28}  # int8/int2/int4/oid/xid
_FLOAT_OIDS = {700, 701, 1700}  # float4/float8/numeric
_BYTEA_OID = 17
_BOOL_OID = 16


def _decode(raw: bytes | None, oid: int) -> Any:
    if raw is None:
        return None
    if oid in _INT_OIDS:
        return int(raw)
    if oid in _FLOAT_OIDS:
        return float(raw)
    if oid == _BOOL_OID:
        return raw == b"t"
    if oid == _BYTEA_OID:
        text = raw.decode("ascii")
        if text.startswith("\\x"):
            return bytes.fromhex(text[2:])
        # legacy octal escape format
        return text.encode("latin-1").decode("unicode_escape").encode(
            "latin-1"
        )
    return raw.decode("utf-8")


# -- SCRAM-SHA-256 (RFC 7677, the modern postgres default auth) -------------


class _Scram:
    def __init__(self, user: str, password: str):
        self._password = password.encode("utf-8")
        self._nonce = base64.b64encode(os.urandom(18)).decode("ascii")
        # channel-binding not attempted over a plain socket → gs2 "n,,"
        self.client_first = f"n,,n=,r={self._nonce}".encode("ascii")
        self._client_first_bare = f"n=,r={self._nonce}"

    def client_final(self, server_first: bytes) -> bytes:
        fields = dict(
            kv.split("=", 1) for kv in server_first.decode("ascii").split(",")
        )
        r, s, i = fields["r"], fields["s"], int(fields["i"])
        if not r.startswith(self._nonce):
            raise OperationalError("SCRAM: server nonce mismatch")
        salted = hashlib.pbkdf2_hmac(
            "sha256", self._password, base64.b64decode(s), i
        )
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = f"c=biws,r={r}"
        auth_msg = ",".join(
            (
                self._client_first_bare,
                server_first.decode("ascii"),
                without_proof,
            )
        ).encode("ascii")
        sig = hmac.digest(stored_key, auth_msg, "sha256")
        proof = bytes(a ^ b for a, b in zip(client_key, sig))
        server_key = hmac.digest(salted, b"Server Key", "sha256")
        self._server_sig = base64.b64encode(
            hmac.digest(server_key, auth_msg, "sha256")
        ).decode("ascii")
        return (
            without_proof + ",p=" + base64.b64encode(proof).decode("ascii")
        ).encode("ascii")

    def verify_server_final(self, server_final: bytes) -> None:
        fields = dict(
            kv.split("=", 1) for kv in server_final.decode("ascii").split(",")
        )
        if fields.get("v") != self._server_sig:
            raise OperationalError("SCRAM: bad server signature")


# -- protocol plumbing ------------------------------------------------------


#: sanity ceiling on a single backend message (1 GiB); a frame length
#: outside [4, MAX] is a corrupt or hostile stream, not a big result
_MAX_FRAME = 1 << 30


class _Wire:
    """Framed reads/writes of protocol v3 messages."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def send(self, type_byte: bytes, payload: bytes) -> None:
        self._sock.sendall(
            type_byte + struct.pack("!I", len(payload) + 4) + payload
        )

    def send_startup(self, payload: bytes) -> None:
        self._sock.sendall(struct.pack("!I", len(payload) + 4) + payload)

    def _read_exact(self, n: int) -> bytes:
        # chunks are joined once: growing one bytes object chunk by
        # chunk copies the whole prefix each time, which is quadratic
        # in a large row (a model blob's hex; ROADMAP.md §3)
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

    def recv(self) -> tuple[bytes, bytes]:
        header = self._read_exact(5)
        (length,) = struct.unpack("!I", header[1:5])
        # the length field counts itself (>=4); reject nonsense before
        # it turns into a negative read or an unbounded buffer
        if not 4 <= length <= _MAX_FRAME:
            raise OperationalError(
                f"protocol violation: frame length {length} out of range"
            )
        return header[:1], self._read_exact(length - 4)


def _parse_error(payload: bytes) -> DatabaseError:
    fields: dict[bytes, str] = {}
    for part in payload.split(b"\x00"):
        if part:
            fields[part[:1]] = part[1:].decode("utf-8", "replace")
    sqlstate = fields.get(b"C", "58000")
    msg = fields.get(b"M", "unknown server error")
    return _error_for(sqlstate, f"{msg} [SQLSTATE {sqlstate}]")


class Connection:
    def __init__(
        self,
        host: str = "localhost",
        port: int = 5432,
        database: str = "postgres",
        user: str = "postgres",
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
        self._wire = _Wire(sock)
        self._sock = sock
        try:
            self._handshake(database, user, password)
        except BaseException:
            self.close()
            raise

    # -- session startup ---------------------------------------------------
    def _handshake(self, database: str, user: str, password: str) -> None:
        params = (
            b"user\x00" + user.encode() + b"\x00"
            b"database\x00" + database.encode() + b"\x00"
            b"client_encoding\x00UTF8\x00\x00"
        )
        self._wire.send_startup(struct.pack("!I", 196608) + params)  # 3.0
        scram: _Scram | None = None
        while True:
            mtype, payload = self._wire.recv()
            if mtype == b"E":
                raise _parse_error(payload)
            if mtype == b"R":
                (code,) = struct.unpack("!I", payload[:4])
                if code == 0:  # AuthenticationOk
                    continue
                if code == 3:  # cleartext
                    self._wire.send(b"p", password.encode() + b"\x00")
                elif code == 5:  # md5(md5(password+user)+salt)
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        password.encode() + user.encode()
                    ).hexdigest()
                    digest = hashlib.md5(
                        inner.encode() + salt
                    ).hexdigest()
                    self._wire.send(b"p", b"md5" + digest.encode() + b"\x00")
                elif code == 10:  # SASL: pick SCRAM-SHA-256
                    mechs = payload[4:].split(b"\x00")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise NotSupportedError(
                            f"server offers no supported SASL mechanism: "
                            f"{mechs}"
                        )
                    scram = _Scram(user, password)
                    first = scram.client_first
                    self._wire.send(
                        b"p",
                        b"SCRAM-SHA-256\x00"
                        + struct.pack("!I", len(first))
                        + first,
                    )
                elif code == 11:  # SASLContinue
                    assert scram is not None
                    self._wire.send(b"p", scram.client_final(payload[4:]))
                elif code == 12:  # SASLFinal
                    assert scram is not None
                    scram.verify_server_final(payload[4:])
                else:
                    raise NotSupportedError(
                        f"unsupported authentication request {code}"
                    )
            elif mtype == b"Z":  # ReadyForQuery
                return
            # S (ParameterStatus), K (BackendKeyData), N (Notice): ignore

    # -- query execution ---------------------------------------------------
    def _query(self, sql: str) -> tuple[list, list, int]:
        """Run one simple-protocol query; returns (columns, rows, rowcount).

        The query string may contain several ``;``-separated statements
        (the simple protocol runs them in one round trip — how
        ``executemany`` amortizes network latency); ``rowcount`` is then
        the SUM of the per-statement affected-row counts.
        """
        if self._closed:
            raise InterfaceError("connection is closed")
        self._wire.send(b"Q", sql.encode("utf-8") + b"\x00")
        columns: list[tuple[str, int]] = []
        rows: list[tuple] = []
        rowcount = -1
        error: DatabaseError | None = None
        while True:
            mtype, payload = self._wire.recv()
            if mtype == b"T":  # RowDescription
                (n,) = struct.unpack("!H", payload[:2])
                off, columns = 2, []
                for _ in range(n):
                    end = payload.index(b"\x00", off)
                    name = payload[off:end].decode("utf-8")
                    table_oid, attnum, type_oid, size, mod, fmt = (
                        struct.unpack("!IHIhih", payload[end + 1:end + 19])
                    )
                    columns.append((name, type_oid))
                    off = end + 19
            elif mtype == b"D":  # DataRow
                (n,) = struct.unpack("!H", payload[:2])
                off, vals = 2, []
                for i in range(n):
                    (ln,) = struct.unpack("!i", payload[off:off + 4])
                    off += 4
                    if ln < 0:
                        raw = None
                    else:
                        raw = payload[off:off + ln]
                        off += ln
                    vals.append(_decode(raw, columns[i][1]))
                rows.append(tuple(vals))
            elif mtype == b"C":  # CommandComplete: e.g. "INSERT 0 3"
                tag = payload.rstrip(b"\x00").decode("ascii")
                tail = tag.rsplit(" ", 1)[-1]
                if tail.isdigit():
                    rowcount = (
                        int(tail) if rowcount < 0 else rowcount + int(tail)
                    )
            elif mtype == b"E":
                error = _parse_error(payload)
            elif mtype == b"Z":
                if error is not None:
                    raise error
                return columns, rows, rowcount
            # I (EmptyQueryResponse), N (Notice), S (ParameterStatus): skip

    def _exec_tx(self, sql: str) -> tuple[list, list, int]:
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

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._sock.sendall(b"X" + struct.pack("!I", 4))
            except OSError:
                pass
            self._sock.close()


class Cursor:
    arraysize = 1

    def __init__(self, conn: Connection):
        self._conn = conn
        self.description: list | None = None
        self.rowcount = -1
        self._rows: list[tuple] = []
        self._idx = 0

    def execute(self, sql: str, params: Sequence[Any] = ()) -> "Cursor":
        columns, rows, rowcount = self._conn._exec_tx(
            interpolate(sql, tuple(params))
        )
        self.description = (
            [(name, oid, None, None, None, None, None) for name, oid in columns]
            or None
        )
        self._rows, self._idx, self.rowcount = rows, 0, rowcount
        return self

    #: statements per round trip in executemany (bounds message size)
    EXECUTEMANY_CHUNK = 200

    def executemany(
        self, sql: str, seq_of_params: Iterable[Sequence[Any]]
    ) -> "Cursor":
        """Interpolate every row and ship them in ``;``-joined groups —
        one network round trip per EXECUTEMANY_CHUNK statements instead
        of one per row (the simple protocol runs a multi-statement
        Query atomically within the surrounding transaction)."""
        import itertools

        stmt_iter = (
            interpolate(sql, tuple(params)) for params in seq_of_params
        )
        total = 0
        while True:
            chunk = list(
                itertools.islice(stmt_iter, self.EXECUTEMANY_CHUNK)
            )
            if not chunk:
                break
            _cols, _rows, count = self._conn._exec_tx(";".join(chunk))
            if count > 0:
                total += count
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
