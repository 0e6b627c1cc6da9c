"""The cluster controller: the elected singleton that recruits and watches
(a trimmed copy of foundationdb_tpu/server/cluster_controller.py).

Reference: fdbserver/ClusterController.actor.cpp -- it wins the election
through the coordinators (clusterControllerCore :4798), keeps the
registry of workers, recruits the master (clusterWatchDatabase :3088) and
recruits another when the master dies or a better placement appears
(betterMasterExists :2214), and broadcasts ServerDBInfo to the workers
and ClientDBInfo to the clients.  Recovery itself is the master's
(server/master.py master_server).

Kept: the worker registry with a failure watch a registration, get_workers,
the ServerDBInfo and ClientDBInfo long polls, the master's registration,
the wait for the recruitment pool, the master's placement by fitness, the
watch of the master's failure and the re-election of a better master.
Left out: the peer-health aggregation and its recovery trigger, the
status document (get_status is registered and not served) and the
protocol version a real transport reports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..core.error import FdbError, err
from ..core.futures import Promise, wait_any
from ..core.scheduler import delay, get_event_loop, now, spawn
from ..core.trace import Severity, TraceEvent
from ..rpc.endpoint import RequestStream
from .failure import WaitFailureRequest, wait_failure_of
from .interfaces import (FITNESS_NEVER, ClientDBInfo,
                         ClusterControllerInterface, InitializeMasterRequest,
                         ServerDBInfo, WorkerInterface, WorkerRegistration,
                         role_fitness, same_incarnation)


@dataclass
class GetServerDBInfoRequest:
    """Long poll: replies (version, ServerDBInfo) once version >
    known_version (the workers' subscription to the broadcast)."""

    known_version: int = -1
    reply: Any = None


SERVING = ("accepting_commits", "fully_recovered")


class ClusterController:
    def __init__(self, cc_id: str, coordinators, config) -> None:
        self.id = cc_id
        self._process = None
        self.coordinators = coordinators
        self.config = config
        self.interface = ClusterControllerInterface(cc_id)
        self.workers: Dict[str, WorkerRegistration] = {}
        self.db_info = ServerDBInfo()
        self.db_info_version = 0
        self._db_info_waiters: List[Promise] = []
        self._client_waiters: List[Promise] = []
        self._worker_arrived: List[Promise] = []
        self._streams_registered = False
        self._actors: List = []

    # -- broadcast -----------------------------------------------------------
    def _publish(self, info: ServerDBInfo) -> None:
        self.db_info = info
        self.db_info_version += 1
        waiters, self._db_info_waiters = self._db_info_waiters, []
        for p in waiters:
            p.send(None)
        cwaiters, self._client_waiters = self._client_waiters, []
        for p in cwaiters:
            p.send(None)

    def client_db_info(self) -> ClientDBInfo:
        return ClientDBInfo(epoch=self.db_info.epoch,
                            grv_proxies=list(self.db_info.grv_proxies),
                            commit_proxies=list(self.db_info.commit_proxies))

    # -- serving -------------------------------------------------------------
    async def _serve_register_worker(self) -> None:
        async for req in self.interface.register_worker.queue:
            cur = self.workers.get(req.worker.id)
            # Watch every new incarnation, not just new ids: a rebooted
            # worker's registration may beat the old watch's failure.
            if cur is None or not same_incarnation(cur.worker, req.worker):
                self._spawn(self._monitor_worker(req.worker.id, req.worker),
                            f"{self.id}.monitorWorker")
            self.workers[req.worker.id] = WorkerRegistration(
                req.worker, req.process_class, req.recovered_logs,
                req.recovered_storage, req.storage_versions,
                req.locality or ("", "", ""), now())
            arrived, self._worker_arrived = self._worker_arrived, []
            for p in arrived:
                p.send(None)
            if getattr(req.reply, "send", None):  # one-way sends: no reply
                req.reply.send(None)

    async def _monitor_worker(self, wid: str, iface: WorkerInterface) -> None:
        """Drop a dead worker from the pool (reference
        workerAvailabilityWatch), if it is still the incarnation
        registered."""
        await wait_failure_of(iface)
        cur = self.workers.get(wid)
        if cur is not None and same_incarnation(cur.worker, iface):
            del self.workers[wid]
            TraceEvent("CCWorkerRemoved", Severity.Warn).detail(
                "Worker", wid).log()

    async def _serve_get_workers(self) -> None:
        async for req in self.interface.get_workers.queue:
            req.reply.send(list(self.workers.values()))

    def _spawn(self, coro, name: str):
        """Handlers die with the controller's process and at halt()."""
        f = self._process.spawn(coro, name) if self._process is not None \
            else spawn(coro, name)
        self._actors.append(f)
        return f

    async def _serve_get_db_info(self) -> None:
        async for req in self.interface.get_server_db_info.queue:
            self._spawn(self._handle_get_db_info(req), f"{self.id}.getDbInfo")

    async def _handle_get_db_info(self, req: GetServerDBInfoRequest) -> None:
        try:
            while req.known_version >= self.db_info_version:
                p: Promise = Promise()
                self._db_info_waiters.append(p)
                await p.get_future()
            req.reply.send((self.db_info_version, self.db_info))
        finally:
            # A parked poll on a halted controller breaks now, not when
            # the collector reaches its reply.
            if not req.reply.is_set():
                req.reply.send_error(err("broken_promise"))

    async def _serve_open_database(self) -> None:
        async for req in self.interface.open_database.queue:
            self._spawn(self._handle_open_database(req), f"{self.id}.openDb")

    async def _handle_open_database(self, req) -> None:
        try:
            while (self.db_info.epoch <= req.known_epoch or
                   self.db_info.recovery_state not in SERVING):
                p: Promise = Promise()
                self._client_waiters.append(p)
                await p.get_future()
            req.reply.send(self.client_db_info())
        finally:
            if not req.reply.is_set():
                req.reply.send_error(err("broken_promise"))

    async def _serve_master_registration(self) -> None:
        async for req in self.interface.master_registration.queue:
            if req.epoch == self.db_info.epoch:
                self._publish(req.db_info)
            req.reply.send(None)

    # -- recruitment (reference clusterWatchDatabase :3088) ------------------
    async def _wait_for_workers(self, n: int) -> None:
        """At least `n` workers and one stateless-class worker; then a
        bounded grace for the storage-class workers, so storage is not
        placed on stateless workers that registered first."""
        def ready() -> bool:
            if len(self.workers) < n:
                return False
            return any(reg.process_class in ("stateless", "unset")
                       for reg in self.workers.values())
        if not ready():
            TraceEvent("CCWaitingForWorkers").detail(
                "Have", len(self.workers)).detail("Need", n).log()
        while not ready():
            p: Promise = Promise()
            self._worker_arrived.append(p)
            await p.get_future()

        def storage_capable() -> int:
            return sum(1 for r in self.workers.values()
                       if r.process_class in ("storage", "unset"))

        want = max(1, min(getattr(self.config, "n_storage", 1),
                          len(self.workers) + 4))
        deadline = get_event_loop().now() + 2.0
        while storage_capable() < want and get_event_loop().now() < deadline:
            p = Promise()
            self._worker_arrived.append(p)
            await wait_any([p.get_future(), delay(0.25)])

    def _pick_master_worker(self) -> WorkerInterface:
        """The best-fitness worker for the master (ties by id)."""
        ranked = sorted(
            (reg for reg in self.workers.values()
             if role_fitness(reg.process_class, "master") < FITNESS_NEVER),
            key=lambda reg: (role_fitness(reg.process_class, "master"),
                             reg.worker.id))
        if not ranked:
            return sorted(self.workers.items())[0][1].worker
        return ranked[0].worker

    async def _better_master_exists(self, master_wid: str) -> None:
        """Returns once a strictly better master placement has appeared
        and stayed a settle second, while the cluster accepts commits."""
        def improvement() -> bool:
            if self.db_info.recovery_state not in SERVING:
                return False
            cur = self.workers.get(master_wid)
            if cur is None:
                return False      # its failure watch handles that
            cur_fit = role_fitness(cur.process_class, "master")
            best = min((role_fitness(reg.process_class, "master")
                        for reg in self.workers.values()), default=cur_fit)
            return best < cur_fit

        while True:
            p: Promise = Promise()
            self._worker_arrived.append(p)
            await wait_any([p.get_future(), delay(2.0)])
            if not p.is_set():
                try:
                    self._worker_arrived.remove(p)
                except ValueError:
                    pass
            if not improvement():
                continue
            await delay(1.0)
            if improvement():
                TraceEvent("CCBetterMasterExists").detail(
                    "CurrentWorker", master_wid).log()
                return

    async def _cluster_watch_database(self) -> None:
        from .coordination import CoordinatedState
        from .master import DBCoreState
        while True:
            try:
                await self._wait_for_workers(self.config.min_workers)
                # The next epoch from the durable core state.
                cstate = CoordinatedState(self.coordinators)
                prev: Optional[DBCoreState] = DBCoreState.coerce(
                    await cstate.read())
                epoch = (prev.epoch + 1) if prev is not None else 1
                worker = self._pick_master_worker()
                self.db_info = ServerDBInfo(epoch=epoch,
                                            recovery_state="recruiting")
                self.db_info_version += 1
                TraceEvent("CCRecruitMaster").detail("Epoch", epoch).detail(
                    "Worker", worker.id).log()
                miface = await RequestStream.at(
                    worker.init_master.endpoint).get_reply(
                    InitializeMasterRequest(epoch=epoch, cc=self.interface))
                # The master's death or a strictly better placement ends
                # this epoch's watch; the next epoch's cstate write fences
                # the old master.
                failure_f = RequestStream.at(
                    miface.wait_failure.endpoint).get_reply(
                    WaitFailureRequest())
                better_f = self._spawn(
                    self._better_master_exists(worker.id),
                    f"{self.id}.betterMaster")
                waiters = [failure_f, better_f]
                try:
                    idx, _ = await wait_any(waiters)
                finally:
                    for f in waiters:
                        if not f.is_ready():
                            f.cancel()
                if idx >= 1:
                    TraceEvent("CCReRecruitMaster").detail(
                        "Epoch", epoch).detail(
                        "Trigger", "betterMaster").log()
                    continue
            except FdbError as e:
                TraceEvent("CCMasterDied", Severity.Warn).detail(
                    "Error", e.name).detail("Message", str(e)).log()
                await delay(0.1)
            except Exception as e:  # noqa: BLE001 -- the watch never dies
                # silently: a wedged controller stops all recruitment while
                # it still leads.
                TraceEvent("CCWatchDatabaseError", Severity.Error).detail(
                    "Error", repr(e)).log()
                await delay(0.5)

    def register_streams(self, process) -> None:
        """Register the endpoints without serving: a candidate's
        endpoints exist before it wins, so early registrations queue."""
        if self._streams_registered:
            return
        self._streams_registered = True
        for s in self.interface.streams():
            process.register(s)

    def run(self, process) -> None:
        self._process = process
        self.register_streams(process)
        self._spawn(self._serve_register_worker(), f"{self.id}.regWorker")
        self._spawn(self._serve_get_workers(), f"{self.id}.getWorkers")
        self._spawn(self._serve_get_db_info(), f"{self.id}.getDbInfo")
        self._spawn(self._serve_open_database(), f"{self.id}.openDb")
        self._spawn(self._serve_master_registration(), f"{self.id}.masterReg")
        self._spawn(self._cluster_watch_database(), f"{self.id}.watchDb")
        # Re-elected after a deposition: watch the workers it knows.
        for wid, reg in list(self.workers.items()):
            self._spawn(self._monitor_worker(wid, reg.worker),
                        f"{self.id}.monitorWorker")
        TraceEvent("ClusterControllerStarted").detail("Id", self.id).log()

    def halt(self) -> None:
        """Stop serving and recruiting (deposed).  The coordinated state
        fences its master's epoch; the registry is kept for a possible
        re-election."""
        TraceEvent("ClusterControllerHalted", Severity.Warn).detail(
            "Id", self.id).log()
        actors, self._actors = self._actors, []
        for a in actors:
            if not a.is_ready():
                a.cancel()
