"""Real-cluster mode of the port: the gRPC solver sidecar, and the HTTP
tier (counterpart of ``grove_tpu/cluster``).

``apiserver`` (k8s-shaped REST over the in-memory store, with the
glass-box faces), ``client`` (``HttpStore``: the Store interface over
HTTP), ``webhook`` and ``cert`` (admission webhooks over TLS), ``lease``
(leader election), ``crdgen`` and ``apidocs`` (CRDs and the API reference
from the typed model), ``autotopo`` (topology from node labels),
``extscheduler`` (the external gang scheduler) and ``manager``
(``start_operator``: the assembled operator, its scheduler on the card
unless the caller passes ``device="cpu"``).
"""
