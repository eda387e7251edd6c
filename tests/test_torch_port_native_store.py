"""The port's native store client (``cassmantle_tpu_torch/native/client.py``)
held against the reference's.

The reference's store-parity script (``tests/test_store_parity.py``:
strings and TTLs, hashes with strtoll-lenient HINCRBY, sets, the
wrong-type discipline, locks with the overrun and expired-in-hold
hazards) runs through the reference's ``MemoryStore`` and ``MantleStore``
and the port's: every reply is equal. Both ``MantleStore``s talk to one
node of the port's own build (``ensure_built``: ``native/mantlestore.cc``
into ``cassmantle_tpu_torch/_build/``), spawned on a port the kernel
picked. Beside it: the build's atomicity across processes, a failed
build's raise, port 0, binary values, lock exclusion across connections,
the client's chunking of large collections, and commands queued on a
connection that another command closes.
"""

import asyncio
import hashlib
import os
import subprocess
import sys

import pytest

import cassmantle_tpu.engine.store as jstore
import cassmantle_tpu.native.client as jclient
import cassmantle_tpu_torch.engine.store as pstore
import cassmantle_tpu_torch.native.client as pclient
import test_store_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def node():
    proc = pclient.spawn_server(0)
    yield proc
    proc.kill()
    proc.wait(timeout=5)


async def _flush(port):
    c = pclient.MantleStore(port=port)
    await c.flushall()
    await c.close()


async def _trace(kind, port, monkeypatch):
    """The parity script's replies through one backend, its lock hazards
    recorded by that package's reporter."""
    hazards = []
    # the script catches its package's LockTimeout: either package's here
    monkeypatch.setattr(test_store_parity, "LockTimeout",
                        (jstore.LockTimeout, pstore.LockTimeout))
    module = jstore if kind.startswith("reference") else pstore
    monkeypatch.setattr(module, "_report_lock_hazard",
                        lambda h, name: hazards.append((h, name)))
    if kind.endswith("memory"):
        store = module.MemoryStore()
    else:
        await _flush(port)
        client = jclient if kind.startswith("reference") else pclient
        store = client.MantleStore(port=port)
    try:
        return await test_store_parity.run_script(store, hazards)
    finally:
        await store.close()


@pytest.mark.parametrize("kind", ["port-memory", "reference-native",
                                  "port-native"])
def test_store_replies_match_the_reference_memory_store(kind, node,
                                                        monkeypatch):
    want = asyncio.run(_trace("reference-memory", node.port, monkeypatch))
    got = asyncio.run(_trace(kind, node.port, monkeypatch))
    assert got == want
    # the hazards were reported: the script's last reply lists them
    assert ("overrun", "over") in got[-1]
    assert ("expired_in_hold", "steal") in got[-1]


def test_binary_is_the_ports_own_build():
    """Built from native/mantlestore.cc under the port's git-ignored
    _build/, named by the source's digest; native/build/ is not touched."""
    path = pclient.ensure_built()
    assert os.path.dirname(path) == os.path.join(REPO, "cassmantle_tpu_torch",
                                                 "_build")
    with open(os.path.join(REPO, "native", "mantlestore.cc"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(pclient.CXX_FLAGS).encode())
    assert os.path.basename(path) == \
        f"mantlestore-{digest.hexdigest()[:16]}"
    assert os.access(path, os.X_OK)
    assert path != jclient.BINARY


def test_build_is_atomic_across_processes(tmp_path):
    """Four processes build into one empty directory at once: each gets
    the same whole binary, which runs, and no temporary file is left."""
    code = ("import sys\n"
            "import cassmantle_tpu_torch.native.client as c\n"
            "c.BUILD_DIR = sys.argv[1]\n"
            "print(c.ensure_built())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    (path,) = paths
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    proc = subprocess.Popen([path, "0"], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        with proc.stderr:
            assert b"listening" in proc.stderr.readline()
    finally:
        proc.kill()
        proc.wait()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(pclient, "SOURCE", str(bad))
    monkeypatch.setattr(pclient, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="mantlestore build failed"):
        pclient.ensure_built()
    assert os.listdir(tmp_path / "build") == []
    with pytest.raises(RuntimeError, match="mantlestore build failed"):
        pclient.spawn_server(0)


def test_port_zero_gives_distinct_listening_nodes():
    a, b = pclient.spawn_server(0), pclient.spawn_server(0)
    try:
        assert a.port != b.port and a.port > 0 and b.port > 0

        async def roundtrip():
            ca = pclient.MantleStore(port=a.port)
            cb = pclient.MantleStore(port=b.port)
            await ca.set("k", "a")
            await cb.set("k", "b")
            got = (await ca.get("k"), await cb.get("k"))
            await ca.close()
            await cb.close()
            return got

        assert asyncio.run(roundtrip()) == (b"a", b"b")
    finally:
        for p in (a, b):
            p.kill()
            p.wait()


def test_a_taken_port_raises(node):
    """A node that cannot bind the asked-for port exits, and spawn_server
    raises with its complaint."""
    with pytest.raises(RuntimeError, match="exited before listening"):
        pclient.spawn_server(node.port)


def test_binary_values_chunking_and_lock_exclusion(node):
    async def run():
        a = pclient.MantleStore(port=node.port)
        b = pclient.MantleStore(port=node.port)
        blob = bytes(range(256)) * 4 + b"\r\n$-1\r\n"
        await a.set("blob", blob)
        assert await b.get("blob") == blob
        # past the node's 1024-argument cap: the client chunks
        members = [f"m{i}" for i in range(1500)]
        await a.sadd("big", *members)
        assert await b.smembers("big") == set(members)
        await a.hset("bigh", mapping={f"f{i}": i for i in range(1200)})
        assert len(await b.hgetall("bigh")) == 1200
        order = []

        async def holder():
            async with a.lock("L", timeout=5.0, blocking_timeout=1.0):
                order.append("a-in")
                await asyncio.sleep(0.3)
                order.append("a-out")

        async def waiter():
            await asyncio.sleep(0.05)
            async with b.lock("L", timeout=5.0, blocking_timeout=2.0):
                order.append("b-in")

        await asyncio.gather(holder(), waiter())
        with pytest.raises(pstore.LockTimeout):
            async with a.lock("M", timeout=5.0, blocking_timeout=0.1):
                async with b.lock("M", timeout=5.0, blocking_timeout=0.15):
                    pass
        await a.close()
        await b.close()
        return order

    assert asyncio.run(run()) == ["a-in", "a-out", "b-in"]


def test_commands_queued_on_a_closed_connection_redial(node):
    """Commands waiting for the connection while it is closed under them
    (what the replicated store does to a failed leader's client) dial
    again and are answered; the one on the wire at the close fails as a
    lost connection (the replicated store's cue to elect), and none
    writes to the closed connection."""

    async def run():
        c = pclient.MantleStore(port=node.port)
        await c.set("k", "v")
        gets = [asyncio.ensure_future(c.get("k")) for _ in range(32)]
        await asyncio.sleep(0)
        await c.close()
        got = await asyncio.gather(*gets, return_exceptions=True)
        await c.close()
        return got

    got = asyncio.run(run())
    lost = [g for g in got if g != b"v"]
    assert len(lost) <= 1
    assert all(isinstance(g, ConnectionError) for g in lost)
