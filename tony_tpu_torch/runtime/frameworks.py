"""TF / PyTorch / Horovod / generic runtime adapters.

Parity adapters for the reference's ``TFRuntime`` / ``PyTorchRuntime`` /
``HorovodRuntime`` / ``MLGenericRuntime`` (SURVEY.md sections 2, 3.2): the
contract is the *environment* each framework's own bootstrapping reads. The
data plane stays delegated (TF gRPC, c10d, Horovod controllers) exactly as in
the reference.

The port's copy of ``tony_tpu/runtime/frameworks.py``, whose first-class
runtime here is ``pytorch``: ``parallel/dist.py`` forms the default process
group from the env it exports. ``ServeRuntime`` exports the gang's env to the
port's decode hosts (``serve/gang.py``). The reference's ``ElasticRuntime``
is not ported yet (ROADMAP queue 1, item 10), and
:func:`tony_tpu_torch.runtime.make_runtime` refuses its framework.
"""

from __future__ import annotations

import json

from tony_tpu_torch.config.config import TonyConfig
from tony_tpu_torch.runtime.base import Runtime, TaskIdentity


class TFRuntime(Runtime):
    """Exports TF_CONFIG (reference: SURVEY.md section 3.2 step 3).

    ``{"cluster": {"ps": [...], "worker": [...]}, "task": {"type": ..., "index": ...}}``
    — consumed by tf.distribute (MultiWorkerMirrored / ParameterServerStrategy)
    and by bare tf.train.Server code.
    """

    name = "tensorflow"

    def build_env(self, identity: TaskIdentity, config: TonyConfig) -> dict[str, str]:
        env = super().build_env(identity, config)
        env["TF_CONFIG"] = json.dumps(
            {
                "cluster": identity.cluster_spec,
                "task": {"type": identity.job_name, "index": identity.index},
            },
            sort_keys=True,
        )
        return env


class PyTorchRuntime(Runtime):
    """Exports the torch.distributed env-var init contract.

    MASTER_ADDR/MASTER_PORT point at the rank-0 task's reserved address;
    RANK/WORLD_SIZE come from the AM rank table; LOCAL_RANK is 0 because the
    substrate schedules one process per container (the reference does the
    same — one executor per container).
    """

    name = "pytorch"

    def build_env(self, identity: TaskIdentity, config: TonyConfig) -> dict[str, str]:
        env = super().build_env(identity, config)
        host, _, port = identity.coordinator_address.rpartition(":")
        env.update(
            {
                "MASTER_ADDR": host,
                "MASTER_PORT": port,
                "RANK": str(identity.process_id),
                "WORLD_SIZE": str(identity.num_processes),
                "LOCAL_RANK": "0",
            }
        )
        return env


class HorovodRuntime(Runtime):
    """Horovod gloo env contract, backed by the AM's rendezvous store.

    The reference runs an AM-side python process hosting a Gloo rendezvous
    server and exports HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT plus rank vars
    (SURVEY.md section 3.4). Same shape here: the AM serves the gloo HTTP
    KV store (runtime.horovod_driver.RendezvousServer) and advertises its
    port via TONY_HOROVOD_RENDEZVOUS_PORT; rank/size come straight from the
    AM rank table.
    """

    name = "horovod"

    def build_env(self, identity: TaskIdentity, config: TonyConfig) -> dict[str, str]:
        import os

        env = super().build_env(identity, config)
        # the rendezvous store lives on the AM; fall back to the coordinator
        # address only if the AM didn't start one (no TONY_* env: unit tests)
        am_host = os.environ.get("TONY_AM_ADDR", "").rpartition(":")[0]
        rdv_port = os.environ.get("TONY_HOROVOD_RENDEZVOUS_PORT", "")
        host, _, port = identity.coordinator_address.rpartition(":")
        if am_host and rdv_port:
            host, port = am_host, rdv_port
        # one slot per container -> local size 1, cross size == world size
        env.update(
            {
                "HOROVOD_CONTROLLER": "gloo",
                "HOROVOD_CPU_OPERATIONS": "gloo",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR": host,
                "HOROVOD_GLOO_RENDEZVOUS_PORT": port,
                "HOROVOD_RANK": str(identity.process_id),
                "HOROVOD_SIZE": str(identity.num_processes),
                "HOROVOD_LOCAL_RANK": "0",
                "HOROVOD_LOCAL_SIZE": "1",
                "HOROVOD_CROSS_RANK": str(identity.process_id),
                "HOROVOD_CROSS_SIZE": str(identity.num_processes),
                "HOROVOD_HOSTNAME": identity.own_address.rpartition(":")[0],
            }
        )
        return env


class MXNetRuntime(Runtime):
    """MXNet parameter-server (DMLC/kvstore) env contract.

    Reference parity for the MXNetRuntime adapter (SURVEY.md section 2
    "Runtime adapters"): DMLC processes find each other through the
    scheduler's address. Job types map directly: ``scheduler`` (1 instance),
    ``server``, ``worker``; the scheduler task doubles as the root URI.
    """

    name = "mxnet"

    def validate(self, config: TonyConfig) -> None:
        if "scheduler" not in config.job_types():
            raise ValueError("mxnet jobs need a [job.scheduler] with instances = 1")
        if config.task_spec("scheduler").instances != 1:
            raise ValueError("mxnet jobs need exactly one scheduler instance")

    def build_env(self, identity: TaskIdentity, config: TonyConfig) -> dict[str, str]:
        env = super().build_env(identity, config)
        schedulers = identity.cluster_spec.get("scheduler", [])
        if len(schedulers) != 1:
            raise ValueError(
                f"mxnet cluster spec needs exactly one scheduler, got {schedulers}"
            )
        host, _, port = schedulers[0].rpartition(":")
        env.update(
            {
                "DMLC_ROLE": identity.job_name,
                "DMLC_PS_ROOT_URI": host,
                "DMLC_PS_ROOT_PORT": port,
                "DMLC_NUM_SERVER": str(len(identity.cluster_spec.get("server", []))),
                "DMLC_NUM_WORKER": str(len(identity.cluster_spec.get("worker", []))),
            }
        )
        return env


class MLGenericRuntime(Runtime):
    """No framework assumptions: just the TONY_* cluster env (base class)."""

    name = "generic"

    def needs_data_port(self) -> bool:
        return True


class ServeRuntime(Runtime):
    """`tony serve` gang workers (serve/gang.py; docs/SERVE.md).

    The serving job type's contract: every decode host LISTENS on the
    data port the executor reserved and registered (the frontend
    discovers hosts at exactly those cluster-spec addresses through the
    AM task table), so the port is exported explicitly as
    TONY_SERVE_PORT; the ``serve.gang.*`` key group rides along as JSON
    (TONY_SERVE_GANG) — the AM -> executor -> worker export path every
    obs.* key group uses — so the worker needs no config-file reparse.
    """

    name = "serve"

    def validate(self, config: TonyConfig) -> None:
        from tony_tpu_torch.config.keys import Keys

        gang_type = config.get_str(Keys.SERVE_GANG_JOB_TYPE, "decode")
        if gang_type not in config.job_types():
            raise ValueError(
                f"serve jobs need a [job.{gang_type}] section (or set "
                "serve.gang.job_type to the decode-host task type)"
            )
        if config.get_int(Keys.SERVE_POOL_PREFILL_HOSTS, 0) > 0:
            ptype = config.get_str(Keys.SERVE_POOL_PREFILL_JOB_TYPE, "prefill")
            if ptype not in config.job_types():
                raise ValueError(
                    f"disaggregated serve jobs need a [job.{ptype}] section "
                    "for the prefill pool (serve.pool.prefill_hosts > 0)"
                )
            if ptype == gang_type:
                raise ValueError(
                    "serve.pool.prefill_job_type must differ from "
                    "serve.gang.job_type (the pools are distinct task types)"
                )

    def needs_data_port(self) -> bool:
        return True

    def build_env(self, identity: TaskIdentity, config: TonyConfig) -> dict[str, str]:
        # import-light on purpose: gang.py defers its engine (and torch)
        # imports, and the serve package exports its engine lazily, so the
        # executor process stays a pure control-plane one
        from tony_tpu_torch.serve.gang import ENV_SERVE_GANG, ENV_SERVE_PORT, GangSettings

        env = super().build_env(identity, config)
        env[ENV_SERVE_PORT] = identity.own_address.rpartition(":")[2]
        env[ENV_SERVE_GANG] = GangSettings.from_config(config).to_json()
        return env


__all__ = [
    "HorovodRuntime",
    "MLGenericRuntime",
    "MXNetRuntime",
    "PyTorchRuntime",
    "ServeRuntime",
    "TFRuntime",
]
