"""Asyncio client for mantlestore, the native C++ state store.

A copy of ``cassmantle_tpu/native/client.py``: :class:`MantleStore`
implements the :class:`StateStore` contract over one node's RESP2 subset,
so N server workers share one node as the reference's workers share one
Redis; blocking lock acquisition polls the node's atomic LOCK/UNLOCK
(token and TTL, self-expiring when a holder dies).

The port builds its own binary: :func:`ensure_built` compiles
``native/mantlestore.cc`` with ``g++ -O2 -std=c++17`` into the
git-ignored ``cassmantle_tpu_torch/_build/mantlestore-<digest>``, the
digest that of the source, so an edited source builds anew. The compiler
writes a name of this process's own and ``os.replace`` puts it in place,
so processes that build at once never see half a binary. A failed build
raises: a fleet whose workers fell back to per-process stores would split
into separate games.

:func:`spawn_server` starts a node (``--repl`` leader or ``--follower``
with a lease). Given port 0 it picks a free port: mantlestore prints the
port it was given, not the one the kernel bound, so the picked port is
passed to it, and a node that lost the port to another process is started
again on a new pick. The process it returns carries its port as ``.port``.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import os
import socket
import subprocess
import tempfile
from typing import Dict, Optional, Set

from cassmantle_tpu_torch.chaos import afault_point
from cassmantle_tpu_torch.engine.store import (
    LockTimeout,
    StateStore,
    Value,
    polled_store_lock,
)

__all__ = ["LockTimeout", "MantleStore", "ensure_built", "spawn_server"]

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PACKAGE_DIR), "native",
                      "mantlestore.cc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall")
# picks of a free port before spawn_server gives up (port 0)
_PORT_PICKS = 5


def binary_path() -> str:
    """Where the binary of the current ``native/mantlestore.cc`` is
    built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"mantlestore-{digest.hexdigest()[:16]}")


def ensure_built() -> str:
    """The path of the built server, compiled first if this source has no
    binary yet; raises RuntimeError when the build fails."""
    out = binary_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="mantlestore-", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"mantlestore build failed (g++ exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"mantlestore build failed: {exc}") from exc
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_server(port: int = 7070,
                 snapshot_path: Optional[str] = None,
                 snapshot_interval_s: float = 30.0,
                 repl: bool = False,
                 follower: bool = False,
                 repl_id: Optional[str] = None,
                 lease_ms: Optional[int] = None) -> subprocess.Popen:
    """Spawn mantlestore on 127.0.0.1:``port`` (0: a free port) and wait
    for its listening line; the process is returned with its port as
    ``.port``. With ``snapshot_path`` the node restores that snapshot at
    boot and persists to it periodically and on SIGTERM.

    ``repl=True`` keeps the replication log and heartbeats the leader
    lease (the node boots as leader); ``follower=True`` boots it
    read-only, waiting for a pump to ship it the leader's log
    (:class:`~cassmantle_tpu_torch.engine.store.ReplicatedStore`).
    ``repl_id`` names the node in the lease (default ``node-<port>``:
    ids must differ, or a follower could promote past a live leader);
    ``lease_ms`` is the lease's TTL."""
    binary = ensure_built()
    for _ in range(_PORT_PICKS if port == 0 else 1):
        bound = port or _free_port()
        cmd = [binary, str(bound)]
        if snapshot_path:
            cmd += [snapshot_path, str(snapshot_interval_s)]
        if repl or follower:
            cmd.append("--follower" if follower else "--repl")
            cmd += ["--id", repl_id or f"node-{bound}"]
            if lease_ms is not None:
                cmd += ["--lease-ms", str(int(lease_ms))]
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE)
        # restore logs precede the listening line; a lost port ends the
        # process with bind's complaint. The pipe closes once read: the
        # node ignores SIGPIPE, and an unread pipe would fill
        lines = []
        with proc.stderr:
            for raw in proc.stderr:
                lines.append(raw.decode(errors="replace"))
                if "listening" in lines[-1]:
                    proc.port = bound
                    return proc
        proc.wait()
    raise RuntimeError(f"mantlestore exited before listening: "
                       f"{''.join(lines).strip()}")


def _b(v: Value) -> bytes:
    return v if isinstance(v, bytes) else str(v).encode()


class MantleStore(StateStore):
    def __init__(self, host: str = "127.0.0.1", port: int = 7070) -> None:
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._io_lock = asyncio.Lock()

    async def connect(self) -> "MantleStore":
        async with self._io_lock:
            await self._open()
        return self

    async def _open(self) -> None:
        """Dial and PING, under the I/O lock."""
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        if await self._roundtrip((b"PING",)) != b"PONG":
            raise ConnectionError(f"{self.host}:{self.port} is not a "
                                  f"mantlestore")

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            with contextlib.suppress(Exception):
                await self._writer.wait_closed()
            self._writer = None
            self._reader = None

    # -- protocol ---------------------------------------------------------
    async def _cmd(self, *args: bytes):
        # the store-boundary fault point: latency here is
        # a slow store, partition (peer-scoped host:port) is a network
        # cut this client treats exactly like a refused connection
        await afault_point("store.client.op",
                           peer=f"{self.host}:{self.port}")
        # the dial happens under the lock too: a command that waited on
        # the lock while a failed round trip closed the connection (the
        # replicated store drops a dead leader's client) redials, or
        # fails as a refused connection, never writes to a closed one
        async with self._io_lock:
            if self._writer is None:
                await self._open()
            return await self._roundtrip(args)

    async def _roundtrip(self, args) -> object:
        payload = b"*%d\r\n" % len(args)
        for a in args:
            payload += b"$%d\r\n%s\r\n" % (len(a), a)
        reader, writer = self._reader, self._writer
        try:
            writer.write(payload)
            await writer.drain()
            return await self._read_reply(reader)
        except asyncio.CancelledError:
            # a cancelled round trip (e.g. an aiohttp handler whose
            # client gave up) may leave this command's reply in
            # flight; the connection is shared, so the NEXT command
            # would read the stale reply and every later caller
            # desyncs. Drop the socket — the next op redials clean.
            if self._writer is writer:
                self._reader, self._writer = None, None
            writer.close()
            raise

    async def raw_command(self, *args: bytes):
        """One command round trip — the public form of ``_cmd`` for
        composition (the shared lock protocol, ReplicatedStore)."""
        return await self._cmd(*args)

    async def _read_reply(self, reader: asyncio.StreamReader):
        line = await reader.readline()
        if not line:
            raise ConnectionError("mantlestore closed connection")
        kind, rest = line[:1], line[1:].strip()
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RuntimeError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = await reader.readexactly(n + 2)
            return data[:-2]
        if kind == b"*":
            return [await self._read_reply(reader)
                    for _ in range(int(rest))]
        raise RuntimeError(f"bad reply kind {kind!r}")

    # -- plain keys -------------------------------------------------------
    async def set(self, key, value):
        await self._cmd(b"SET", key.encode(), _b(value))

    async def get(self, key):
        return await self._cmd(b"GET", key.encode())

    async def setex(self, key, ttl, value):
        await self._cmd(b"SETEX", key.encode(),
                        str(int(ttl * 1000)).encode(), _b(value))

    async def delete(self, *keys):
        if keys:
            await self._cmd(b"DEL", *[k.encode() for k in keys])

    async def exists(self, key):
        return bool(await self._cmd(b"EXISTS", key.encode()))

    async def expire(self, key, ttl):
        await self._cmd(b"PEXPIRE", key.encode(),
                        str(int(ttl * 1000)).encode())

    async def ttl(self, key):
        ms = await self._cmd(b"PTTL", key.encode())
        if ms in (-1, -2):
            return float(ms)
        return ms / 1000.0

    # The server's RESP parser caps commands at 1024 args; multi-member
    # writes are chunked client-side so arbitrarily large collections
    # never wedge the connection (a too-long command would never parse
    # and the reply would never come).
    _CHUNK = 500

    async def _cmd_chunked(self, head, pairs_or_members, stride):
        for i in range(0, len(pairs_or_members), self._CHUNK * stride):
            await self._cmd(*head,
                            *pairs_or_members[i:i + self._CHUNK * stride])

    # -- hashes -----------------------------------------------------------
    async def hset(self, key, field=None, value=None, mapping=None):
        args = []
        if field is not None:
            args += [field.encode(), _b(value)]
        if mapping:
            for k, v in mapping.items():
                args += [k.encode(), _b(v)]
        if args:
            await self._cmd_chunked([b"HSET", key.encode()], args, 2)

    async def hget(self, key, field):
        return await self._cmd(b"HGET", key.encode(), field.encode())

    async def hgetall(self, key) -> Dict[str, bytes]:
        flat = await self._cmd(b"HGETALL", key.encode())
        return {
            flat[i].decode(): flat[i + 1] for i in range(0, len(flat), 2)
        }

    async def hdel(self, key, *fields):
        if fields:
            await self._cmd_chunked([b"HDEL", key.encode()],
                                    [f.encode() for f in fields], 1)

    async def hincrby(self, key, field, amount: int = 1) -> int:
        return await self._cmd(b"HINCRBY", key.encode(), field.encode(),
                               str(amount).encode())

    # -- sets -------------------------------------------------------------
    async def sadd(self, key, *members):
        if members:
            await self._cmd_chunked([b"SADD", key.encode()],
                                    [m.encode() for m in members], 1)

    async def srem(self, key, *members):
        if members:
            await self._cmd_chunked([b"SREM", key.encode()],
                                    [m.encode() for m in members], 1)

    async def smembers(self, key) -> Set[str]:
        return {m.decode() for m in await self._cmd(b"SMEMBERS",
                                                    key.encode())}

    async def sismember(self, key, member) -> bool:
        return bool(await self._cmd(b"SISMEMBER", key.encode(),
                                    member.encode()))

    # -- locks ------------------------------------------------------------
    def lock(self, name: str, timeout: float = 120.0,
             blocking_timeout: float = 2.0):
        # the shared polled protocol (engine/store.py): one definition
        # of the acquire loop and the :2/:0 hazard taxonomy for both
        # the single-node and replicated transports
        return polled_store_lock(self._cmd, name, timeout,
                                 blocking_timeout)

    async def flushall(self) -> None:
        await self._cmd(b"FLUSHALL")

    # -- replication (REPL verbs; see native/mantlestore.cc header) --------
    async def repl_role(self) -> str:
        return (await self._cmd(b"REPL", b"ROLE")).decode()

    async def repl_offset(self) -> tuple:
        """(log_start, log_end, applied). On a healthy node
        applied == log_end; lag of a follower = leader log_end - this."""
        start, end, applied = await self._cmd(b"REPL", b"OFFSET")
        return start, end, applied

    async def repl_tail(self, offset: int, max_commands: int = 256):
        """(next_offset, raw command stream) from ``offset``; None when
        the log was trimmed past it (caller must full-resync via
        repl_dump/repl_reset)."""
        reply = await self._cmd(b"REPL", b"TAIL", str(offset).encode(),
                                str(max_commands).encode())
        if len(reply) == 1:
            return None
        return reply[0], reply[1]

    async def repl_apply(self, expected_offset: int, stream: bytes) -> int:
        """Replay ``stream`` iff this follower's offset == expected;
        returns the follower's applied offset either way (exactly-once
        under racing pumps)."""
        return await self._cmd(b"REPL", b"APPLY",
                               str(expected_offset).encode(), stream)

    async def repl_dump(self) -> tuple:
        """(log_end, full-state command stream incl. live locks)."""
        end, stream = await self._cmd(b"REPL", b"DUMP")
        return end, stream

    async def repl_reset(self, offset: int, stream: bytes) -> int:
        """Full resync: flush, replay ``stream`` unlogged, set offsets."""
        return await self._cmd(b"REPL", b"RESET", str(offset).encode(),
                               stream)

    async def repl_promote(self) -> bool:
        """Ask a follower to take leadership; True when it did (False =
        the replicated leader lease is still live — the leader was
        heartbeating within its TTL)."""
        return await self._cmd(b"REPL", b"PROMOTE") == b"OK"

    async def repl_lease(self) -> tuple:
        """(holder id or '', seconds remaining) of the leader lease as
        this node sees it."""
        holder, ms = await self._cmd(b"REPL", b"LEASE")
        return holder.decode(), ms / 1000.0
