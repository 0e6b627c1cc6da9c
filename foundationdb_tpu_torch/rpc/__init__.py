"""The RPC and simulation layer (the port of foundationdb_tpu/rpc/,
reference fdbrpc/): typed request streams over a simulated network with
deterministic latency, clogging, partitions and process kill/reboot
(network.py, sim.py), the failure monitor, per-peer health samples, the
tagged and columnar wire format (serde.py) and the real TCP network that
carries it between OS processes (real_network.py, transport.py)."""

from .endpoint import (TRANSPORT_ERRORS, Endpoint, NetworkAddress,
                       ReplyPromise, RequestStream)
from .failure_monitor import FailureMonitor
from .network import SimNetwork, get_network, set_network
from .sim import SimProcess, Simulator, get_simulator, set_simulator

__all__ = [
    "Endpoint", "FailureMonitor", "NetworkAddress", "ReplyPromise",
    "RequestStream", "SimNetwork", "SimProcess", "Simulator",
    "TRANSPORT_ERRORS", "get_network", "get_simulator", "set_network",
    "set_simulator",
]
