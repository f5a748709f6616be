"""Webhook TLS certificate management.

Counterpart of ``grove_tpu/cluster/cert.py``, with the same names, wire
format and status codes.

Re-host of the reference cert controller
(upstream operator/internal/controller/cert/cert.go:38-60): generate a
self-signed CA plus a serving certificate for the webhook endpoint, persist
them to a cert directory, and rotate when nearing expiry. Uses the system
openssl binary (no extra Python deps); consumers wait on `ensure_certs`
exactly like the reference's certsReady channel gate
(manager.go:52-63 WaitTillWebhookCertsReady).
"""

from __future__ import annotations

import datetime
import pathlib
import subprocess
from dataclasses import dataclass


@dataclass
class CertPaths:
    ca_cert: pathlib.Path
    server_cert: pathlib.Path
    server_key: pathlib.Path


def _run(args) -> None:
    subprocess.run(args, check=True, capture_output=True)


def generate_certs(
    cert_dir: str, host: str = "127.0.0.1", days: int = 365
) -> CertPaths:
    """Self-signed CA + host serving cert (SAN for IP and localhost)."""
    d = pathlib.Path(cert_dir)
    d.mkdir(parents=True, exist_ok=True)
    ca_key, ca_crt = d / "ca.key", d / "ca.crt"
    srv_key, srv_csr, srv_crt = d / "tls.key", d / "tls.csr", d / "tls.crt"
    ext = d / "san.cnf"
    _run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", str(ca_key), "-out", str(ca_crt),
            "-days", str(days), "-subj", "/CN=grove-tpu-webhook-ca",
        ]
    )
    ext.write_text(
        "subjectAltName=" + ",".join(
            [f"IP:{host}" if host[0].isdigit() else f"DNS:{host}",
             "DNS:localhost", "IP:127.0.0.1"]
        )
        + "\n"
    )
    _run(
        [
            "openssl", "req", "-newkey", "rsa:2048", "-nodes",
            "-keyout", str(srv_key), "-out", str(srv_csr),
            "-subj", "/CN=grove-tpu-webhook",
        ]
    )
    _run(
        [
            "openssl", "x509", "-req", "-in", str(srv_csr),
            "-CA", str(ca_crt), "-CAkey", str(ca_key), "-CAcreateserial",
            "-out", str(srv_crt), "-days", str(days),
            "-extfile", str(ext),
        ]
    )
    return CertPaths(ca_cert=ca_crt, server_cert=srv_crt, server_key=srv_key)


def _expires_within(cert: pathlib.Path, seconds: float) -> bool:
    out = subprocess.run(
        ["openssl", "x509", "-enddate", "-noout", "-in", str(cert)],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    # notAfter=Mar  1 00:00:00 2027 GMT
    stamp = out.split("=", 1)[1]
    expiry = datetime.datetime.strptime(stamp, "%b %d %H:%M:%S %Y %Z").replace(tzinfo=datetime.timezone.utc)
    remaining = (expiry - datetime.datetime.now(datetime.timezone.utc)).total_seconds()
    return remaining < seconds


def ensure_certs(
    cert_dir: str,
    host: str = "127.0.0.1",
    rotate_before_seconds: float = 30 * 24 * 3600,
) -> CertPaths:
    """Idempotent: reuse valid certs, regenerate when missing or within the
    rotation window (cert.go rotation semantics)."""
    d = pathlib.Path(cert_dir)
    paths = CertPaths(d / "ca.crt", d / "tls.crt", d / "tls.key")
    if all(p.exists() for p in (paths.ca_cert, paths.server_cert, paths.server_key)):
        if not _expires_within(paths.server_cert, rotate_before_seconds):
            return paths
    return generate_certs(cert_dir, host)
