"""The sidecar's wire contract: ``solver.proto`` (``grove.solver.v1``) and
the standard ``health.proto`` (``grpc.health.v1``), with their
protoc-generated message modules. The port keeps its own copies of the JAX
package's files, byte for byte the same contract: where both packages load
in one process, protobuf's descriptor pool serves both modules the same
message classes.
"""
