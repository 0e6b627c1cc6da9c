"""The simulator's process surface: processes, machines, kill/reboot/clog
fault APIs (a trimmed copy of foundationdb_tpu/rpc/sim.py).

Reference: fdbrpc/simulator.h — ISimulator with ProcessInfo (:66),
MachineInfo (:195), killProcess/killMachine/rebootProcess (:226-243),
clogInterface/clogPair (:375-376).  All simulated processes are actors in
ONE OS process sharing the deterministic event loop; process boundaries are
the SimNetwork's latency/failure model plus actor-cancellation on kill.

Each machine carries its simulated file system (server/sim_fs.py, the
port's copy: synchronous files whose un-synced writes a power failure
keeps, drops or tears), reached through fs_for(process);
power_fail_machine and power_fail_all kill processes and fail those
writes.  Left out:
wipe_machine.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..core.futures import AsyncVar, Future
from ..core.scheduler import get_event_loop
from ..core.trace import Severity, TraceEvent
from .endpoint import NetworkAddress, RequestStream
from .network import SimNetwork, get_network


class Locality:
    """Placement attributes (reference fdbrpc/Locality.h LocalityData)."""

    def __init__(self, dcid: str = "dc0", zoneid: str = "",
                 machineid: str = "") -> None:
        self.dcid = dcid
        self.zoneid = zoneid or machineid
        self.machineid = machineid

    def __repr__(self) -> str:  # pragma: no cover
        return f"Locality(dc={self.dcid}, zone={self.zoneid}, machine={self.machineid})"


class SimProcess:
    """One simulated fdbserver-like process (reference ProcessInfo)."""

    def __init__(self, address: NetworkAddress, locality: Locality,
                 process_class: str = "unset", name: str = "") -> None:
        self.address = address
        self.locality = locality
        self.process_class = process_class
        self.name = name or str(address)
        self.alive = True
        self.epoch = 0            # bumped on reboot; stale endpoints die
        self.excluded = False
        self._actors: List[Future] = []
        self._tokens: set = set()
        self.shutdown_signal: AsyncVar = AsyncVar(None)  # set to "kill"/"reboot"

    def spawn(self, coro, name: str = "") -> Future:
        """Start an actor owned by this process; cancelled on kill/reboot."""
        f = get_event_loop().spawn(coro, name or f"{self.name}:actor")
        # Pin the actor (and, via inheritance, everything it spawns) to
        # this process: the sim network reads it as the source address
        # of outgoing requests, so clogs/partitions apply for real.
        if f._source_task is not None:
            f._source_task.process = self
        self._actors.append(f)
        self._actors = [a for a in self._actors if not a.is_ready()]
        return f

    def register(self, stream: RequestStream, token: Optional[str] = None):
        return get_network().register(self, stream, token)

    def _halt(self) -> None:
        get_network().unregister_process(self.address)
        self._tokens.clear()
        actors, self._actors = self._actors, []
        for a in actors:
            if not a.is_ready():
                a.cancel()

    def die(self, reason: str = "") -> None:
        """Process suicide from within one of its own actors (reference:
        io_error and other fatal role errors kill the whole fdbserver
        process).  Deferred so the calling actor isn't cancelled
        mid-step; watchers see broken promises / failure monitors fire."""
        if not self.alive:
            return
        TraceEvent("ProcessSuicide", Severity.Warn).detail(
            "Process", self.name).detail("Reason", reason).log()
        self.alive = False
        self.shutdown_signal.set("kill")
        get_event_loop().call_soon(self._halt)


class Machine:
    """A simulated machine hosting processes (reference MachineInfo)."""

    def __init__(self, machineid: str, dcid: str) -> None:
        from ..server.sim_fs import SimFileSystem
        self.machineid = machineid
        self.dcid = dcid
        self.processes: List[SimProcess] = []
        self.fs = SimFileSystem()


class Simulator:
    """Cluster-level fault injection + topology registry (reference
    ISimulator / g_simulator)."""

    def __init__(self) -> None:
        self.network = SimNetwork()
        self.machines: Dict[str, Machine] = {}
        self.processes: Dict[NetworkAddress, SimProcess] = {}
        self._next_ip = 1
        self.speed_up_simulation = False
        # Hook the cluster harness installs to restart a process after
        # reboot (reference simulatedFDBDRebooter's restart loop).
        self.on_reboot: Optional[Callable[[SimProcess], None]] = None

    # -- topology -----------------------------------------------------------
    def new_process(self, machineid: str = "", dcid: str = "dc0",
                    process_class: str = "unset", name: str = "",
                    zoneid: str = "",
                    address: Optional[NetworkAddress] = None) -> SimProcess:
        """With `address`, the new process REUSES a dead process's
        network address (a restarted server comes back on the same
        host:port, so well-known-token endpoints — coordinators — stay
        valid); the previous holder must be dead."""
        if address is not None:
            old = self.processes.get(address)
            if old is not None and old.alive:
                raise RuntimeError(
                    f"address {address} still held by live {old.name}")
            ip = address.ip
        else:
            ip = f"10.0.{self._next_ip >> 8}.{self._next_ip & 0xff}"
            self._next_ip += 1
        machineid = machineid or f"m{ip}"
        mach = self.machines.get(machineid)
        if mach is None:
            mach = self.machines[machineid] = Machine(machineid, dcid)
        p = SimProcess(NetworkAddress(ip, 4500),
                       Locality(dcid=dcid, machineid=machineid,
                                zoneid=zoneid),
                       process_class, name)
        mach.processes.append(p)
        self.processes[p.address] = p
        self.network.processes[p.address] = p
        return p

    def alive_processes(self) -> List[SimProcess]:
        return [p for p in self.processes.values() if p.alive]

    def fs_for(self, p: SimProcess):
        """The SimFileSystem of the machine hosting `p` (durable state)."""
        return self.machines[p.locality.machineid].fs

    # -- faults (reference simulator.h:226-243, :375-376) --------------------
    def kill_process(self, p: SimProcess) -> None:
        """Permanently stop a process (KillType KillInstantly)."""
        if not p.alive:
            return
        TraceEvent("SimKillProcess", Severity.Warn).detail(
            "Process", p.name).detail("Address", str(p.address)).log()
        p.alive = False
        p.shutdown_signal.set("kill")
        p._halt()

    def reboot_process(self, p: SimProcess) -> None:
        """Stop then restart a process: actors die, endpoints invalidate,
        epoch increments; the harness's on_reboot hook re-runs its roles."""
        if not p.alive:
            return
        TraceEvent("SimRebootProcess", Severity.Warn).detail(
            "Process", p.name).detail("Address", str(p.address)).log()
        p.shutdown_signal.set("reboot")
        p._halt()
        p.epoch += 1
        p.shutdown_signal = AsyncVar(None)
        if self.on_reboot is not None:
            hook = self.on_reboot
            get_event_loop().call_soon(lambda: hook(p))

    def kill_machine(self, machineid: str) -> None:
        for p in self.machines[machineid].processes:
            self.kill_process(p)

    def power_fail_machine(self, machineid: str) -> None:
        """Unclean machine loss: its processes die and its files lose
        every un-synced write."""
        m = self.machines[machineid]
        m.fs.power_fail_all()
        for p in m.processes:
            self.kill_process(p)

    def power_fail_all(self) -> None:
        """Whole-cluster power loss (the restarting tests' scenario)."""
        for machineid in list(self.machines):
            self.power_fail_machine(machineid)

    def kill_zone(self, zoneid: str) -> None:
        """Kill every process in a failure zone (reference killZone,
        simulator.h KillType on zoneId)."""
        for p in list(self.processes.values()):
            if p.locality.zoneid == zoneid:
                self.kill_process(p)

    def kill_datacenter(self, dcid: str) -> None:
        for m in self.machines.values():
            if m.dcid == dcid:
                for p in m.processes:
                    self.kill_process(p)

    def clog_pair(self, a: SimProcess, b: SimProcess, seconds: float) -> None:
        self.network.clog_pair(a.address.ip, b.address.ip, seconds)

    def clog_process(self, p: SimProcess, seconds: float) -> None:
        """Clog ALL of one process's traffic (reference clogInterface) —
        the unit the swizzle nemesis toggles."""
        self.network.clog_ip(p.address.ip, seconds)

    def unclog_process(self, p: SimProcess) -> None:
        self.network.unclog_ip(p.address.ip)

    def clog_machine(self, machineid: str, seconds: float) -> None:
        for p in self.machines[machineid].processes:
            if p.alive:
                self.clog_process(p, seconds)

    def unclog_machine(self, machineid: str) -> None:
        for p in self.machines[machineid].processes:
            self.unclog_process(p)

    def gray_clog_pair(self, a: SimProcess, b: SimProcess,
                       extra_latency: float, seconds: float) -> None:
        """Latency-inflate one live link (grayClog): delivery
        still happens, just `extra_latency` slower each way — the
        gray-failure shape only the peer-health plane can observe."""
        self.network.gray_clog_pair(a.address.ip, b.address.ip,
                                    extra_latency, seconds)

    def ungray_pair(self, a: SimProcess, b: SimProcess) -> None:
        self.network.ungray_pair(a.address.ip, b.address.ip)

    def partition(self, a: SimProcess, b: SimProcess) -> None:
        self.network.partition_pair(a.address.ip, b.address.ip)

    def heal_pair(self, a: SimProcess, b: SimProcess) -> None:
        self.network.heal_partition(a.address.ip, b.address.ip)

    def heal(self) -> None:
        self.network.heal_all()


_simulator: Optional[Simulator] = None


def set_simulator(sim: Optional[Simulator]) -> None:
    """Install `sim` as the global simulator AND its network as the global
    network (reference: g_simulator is also g_network in sim)."""
    global _simulator
    _simulator = sim
    from .network import set_network
    set_network(sim.network if sim is not None else None)


def get_simulator() -> Simulator:
    from ..core.error import err
    if _simulator is None:
        raise err("internal_error", "no Simulator installed (set_simulator)")
    return _simulator
