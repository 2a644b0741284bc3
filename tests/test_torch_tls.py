"""Mutual-TLS transport (security/tls.py, reference weed/security/tls.go).

Generates a throwaway CA + role cert with the openssl CLI, then runs a
master + volume server over HTTPS with client-cert verification and
exercises assign/write/read; a certificate-less client must be refused.

The cases of tests/test_tls.py pointed at the port: a reference master
(the port has none yet) and a port volume server. Each package keeps its
own TLS registry, so the cluster case configures both, and shows that
configuring the reference's alone leaves the port on plain HTTP.
"""

from __future__ import annotations

import os
import shutil
import ssl
import subprocess

import aiohttp
import pytest

from test_torch_cluster_util import run

from seaweedfs_tpu.master.server import MasterServer
from seaweedfs_tpu.security import tls as ref_tls
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.store import Store

pytestmark = pytest.mark.skipif(
    shutil.which("openssl") is None, reason="openssl unavailable")


def _gen_certs(d: str) -> tuple[str, str, str]:
    def sh(*cmd):
        subprocess.run(cmd, check=True, capture_output=True, cwd=d)

    sh("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
       "-keyout", "ca.key", "-out", "ca.crt", "-days", "1",
       "-subj", "/CN=swtpu-test-ca")
    sh("openssl", "req", "-newkey", "rsa:2048", "-nodes",
       "-keyout", "node.key", "-out", "node.csr", "-subj", "/CN=swtpu-node")
    sh("openssl", "x509", "-req", "-in", "node.csr", "-CA", "ca.crt",
       "-CAkey", "ca.key", "-CAcreateserial", "-out", "node.crt",
       "-days", "1")
    return (os.path.join(d, "ca.crt"), os.path.join(d, "node.crt"),
            os.path.join(d, "node.key"))


def test_mtls_cluster_write_read(tmp_path):
    ca, cert, key = _gen_certs(str(tmp_path))

    async def body():
        ref_tls.configure(ca, cert, key)
        assert not tls.enabled() and tls.server_ctx() is None
        tls.configure(ca, cert, key)
        master = vs = None
        try:
            master = MasterServer(port=0, pulse_seconds=0.2,
                                  volume_size_limit_mb=64)
            await master.start()
            store = Store([os.path.join(str(tmp_path), "v0")],
                          max_volume_counts=[8])
            vs = VolumeServer(store, master.url, port=0, pulse_seconds=0.2)
            await vs.start()
            await vs.heartbeat_once()

            http = tls.make_session()
            try:
                async with http.post(
                        tls.url(master.url, "/dir/assign")) as resp:
                    a = await resp.json()
                assert "fid" in a, a
                body_bytes = (b"--B\r\nContent-Disposition: form-data; "
                              b"name=\"file\"; filename=\"t\"\r\n\r\n"
                              b"tls payload\r\n--B--\r\n")
                async with http.post(
                        tls.url(a["url"], f"/{a['fid']}"),
                        data=body_bytes,
                        headers={"Content-Type":
                                 "multipart/form-data; boundary=B"}) as resp:
                    assert resp.status == 201, await resp.text()
                async with http.get(
                        tls.url(a["url"], f"/{a['fid']}")) as resp:
                    assert resp.status == 200
                    assert await resp.read() == b"tls payload"
            finally:
                await http.close()

            # a client WITHOUT a certificate must be refused by the
            # handshake (CERT_REQUIRED on the server side)
            anon_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            anon_ctx.load_verify_locations(ca)
            anon_ctx.check_hostname = False
            anon = aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(ssl=anon_ctx))
            try:
                with pytest.raises(aiohttp.ClientError):
                    async with anon.get(
                            tls.url(master.url, "/stats/health")) as resp:
                        await resp.read()
                with pytest.raises(aiohttp.ClientError):
                    async with anon.get(
                            tls.url(vs.url, "/status")) as resp:
                        await resp.read()
            finally:
                await anon.close()

            # plain http must not work either
            plain = aiohttp.ClientSession()
            try:
                with pytest.raises(aiohttp.ClientError):
                    async with plain.get(
                            f"http://{master.url}/stats/health") as resp:
                        await resp.read()
                with pytest.raises(aiohttp.ClientError):
                    async with plain.get(
                            f"http://{vs.url}/status") as resp:
                        await resp.read()
            finally:
                await plain.close()
        finally:
            if vs:
                await vs.stop()
            if master:
                await master.stop()

    try:
        run(body())
    finally:
        tls.reset()
        ref_tls.reset()


def test_configure_from_toml(tmp_path):
    ca, cert, key = _gen_certs(str(tmp_path))
    toml = tmp_path / "security.toml"
    toml.write_text(
        f'[tls]\nca = "{ca}"\ncert = "{cert}"\nkey = "{key}"\n')
    try:
        assert tls.configure_from_toml(str(toml)) is True
        assert tls.enabled() and tls.scheme() == "https"
        assert tls.url("h:1", "/x") == "https://h:1/x"
    finally:
        tls.reset()
    assert tls.scheme() == "http"
    # empty/absent [tls] leaves plaintext
    (tmp_path / "empty.toml").write_text("[jwt.signing]\nkey = \"\"\n")
    assert tls.configure_from_toml(str(tmp_path / "empty.toml")) is False
    assert not tls.enabled()
