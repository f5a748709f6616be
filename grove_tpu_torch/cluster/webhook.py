"""Admission webhook HTTP(S) server.

Counterpart of ``grove_tpu/cluster/webhook.py``, with the same names, wire
format and status codes.

The webhook surface of upstream operator/internal/webhook/register.go:
defaulting (mutating), validation (create + update, incl. ClusterTopology),
and the authorizer — served as AdmissionReview-speaking HTTP endpoints backed
by the pure functions in grove_tpu_torch.admission. The mutating response returns
the fully defaulted object in `response.patchedObject` (a documented
simplification of the reference's JSONPatch encoding — same wire boundary,
simpler patch algebra).

Runs plain HTTP or TLS with certs from grove_tpu_torch.cluster.cert (the cert
controller re-host); registrations for the apiserver come from
`default_registrations`.
"""

from __future__ import annotations

import json
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from grove_tpu_torch.admission.authorization import AuthorizationGuard
from grove_tpu_torch.admission.defaulting import default_podcliqueset
from grove_tpu_torch.admission.validation import (
    validate_cluster_topology,
    validate_podcliqueset,
    validate_podcliqueset_update,
)
from grove_tpu_torch.api.serialize import export_object
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.cluster.apiserver import WebhookRegistration
from grove_tpu_torch.cluster.cert import CertPaths


class WebhookServer:
    def __init__(
        self,
        topology: Optional[ClusterTopology] = None,
        guard: Optional[AuthorizationGuard] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        certs: Optional[CertPaths] = None,
    ) -> None:
        self.topology = topology or ClusterTopology()
        self.guard = guard
        self.certs = certs
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        if certs is not None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(str(certs.server_cert), str(certs.server_key))
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True
            )
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        scheme = "https" if self.certs is not None else "http"
        return f"{scheme}://{host}:{port}"

    def start(self) -> "WebhookServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="grove-webhooks", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def registrations(self) -> List[WebhookRegistration]:
        """What the reference registers on its webhook server
        (register.go:35-75): PCS defaulting + validation, ClusterTopology
        validation, and the authorizer over grove-managed child kinds."""
        ca = str(self.certs.ca_cert) if self.certs is not None else None
        regs = [
            WebhookRegistration(
                name="default-podcliqueset",
                kinds=["PodCliqueSet"],
                url=f"{self.address}/webhooks/mutate-podcliqueset",
                mutating=True,
                ca_file=ca,
            ),
            WebhookRegistration(
                name="validate-podcliqueset",
                kinds=["PodCliqueSet"],
                url=f"{self.address}/webhooks/validate-podcliqueset",
                ca_file=ca,
            ),
            WebhookRegistration(
                name="validate-clustertopology",
                kinds=["ClusterTopology"],
                url=f"{self.address}/webhooks/validate-clustertopology",
                ca_file=ca,
            ),
        ]
        if self.guard is not None:
            from grove_tpu_torch.admission.authorization import MANAGED_KINDS

            regs.append(
                WebhookRegistration(
                    name="authorize-managed-resources",
                    kinds=list(MANAGED_KINDS),
                    url=f"{self.address}/webhooks/authorize",
                    operations=("CREATE", "UPDATE", "DELETE"),
                    ca_file=ca,
                )
            )
        return regs

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _respond(self, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _review_response(
                self,
                allowed: bool,
                message: str = "",
                patched: Optional[dict] = None,
            ) -> dict:
                out = {
                    "apiVersion": "admission.k8s.io/v1",
                    "kind": "AdmissionReview",
                    "response": {"allowed": allowed},
                }
                if message:
                    out["response"]["status"] = {"message": message}
                if patched is not None:
                    out["response"]["patchType"] = "Full"
                    out["response"]["patchedObject"] = patched
                return out

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                review = json.loads(self.rfile.read(length) or b"{}")
                request = review.get("request") or {}
                endpoint = self.path.rstrip("/").rsplit("/", 1)[-1]
                try:
                    handler = {
                        "mutate-podcliqueset": self._mutate_pcs,
                        "validate-podcliqueset": self._validate_pcs,
                        "validate-clustertopology": self._validate_topology,
                        "authorize": self._authorize,
                    }.get(endpoint)
                    if handler is None:
                        return self._respond(
                            self._review_response(
                                False, f"unknown webhook {endpoint!r}"
                            )
                        )
                    return self._respond(handler(request))
                except Exception as e:  # webhook crash = denial, not 500 loop
                    return self._respond(
                        self._review_response(False, f"webhook error: {e}")
                    )

            def _mutate_pcs(self, request: dict) -> dict:
                pcs = decode_object(request["object"])
                default_podcliqueset(pcs)
                return self._review_response(True, patched=export_object(pcs))

            def _validate_pcs(self, request: dict) -> dict:
                pcs = decode_object(request["object"])
                if request.get("operation") == "UPDATE" and request.get(
                    "oldObject"
                ):
                    old = decode_object(request["oldObject"])
                    res = validate_podcliqueset_update(
                        pcs, old, server.topology
                    )
                else:
                    res = validate_podcliqueset(pcs, server.topology)
                if res.ok:
                    return self._review_response(True)
                return self._review_response(False, "; ".join(res.errors))

            def _validate_topology(self, request: dict) -> dict:
                topo = decode_object(request["object"])
                res = validate_cluster_topology(topo)
                if res.ok:
                    return self._review_response(True)
                return self._review_response(False, "; ".join(res.errors))

            def _authorize(self, request: dict) -> dict:
                obj = decode_object(request["object"])
                username = (request.get("userInfo") or {}).get("username", "")
                decision = server.guard.check(
                    username, request.get("operation", "").lower(), obj
                )
                return self._review_response(decision.allowed, decision.reason)

        return Handler
