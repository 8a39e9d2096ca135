"""Elastic training: survive a lost member without a cold restart. The
port's counterpart of ``tony_tpu/elastic/``.

A job of ``n_members`` members trains on; when a member is lost, a new
cluster generation names the survivors, and ``fit()`` reshards at the next
step boundary: every rank fences and shadows its state
(:class:`ShadowStore`), the process group is formed again over the
survivors' ranks, the mesh is rebuilt over it with dp = the member count
(:class:`ElasticTopology`), the dead member's unconsumed batches are
skipped and declared (:class:`ElasticBatchStream`), and training goes on.
A member that grows back receives the whole state by broadcast from a
survivor. The reference is one controller process owning every member's
devices; the port runs one process per rank (``train/loop.py``).

In a job (the ``elastic`` runtime) every member is a rank of one group:
the chief trains as member 0, and every other member's user process is
``python -m tony_tpu_torch.elastic.member``, which runs the chief's
command as its rank (``member.py``). A member lost in the middle of a
step breaks that step's collectives on every survivor: the survivors wait
for the AM's shrink generation, re-form their group without it and redo
the step from the state they held; the relaunched member joins the
running gang at the grow boundary (``train/loop.py`` ``_Elastic``).

The protocol layer (generation records, controller, journals) is
stdlib-only so a control-plane process imports it without torch; the
torch-side pieces (topology/shadow/data) load lazily.
"""

from tony_tpu_torch.elastic.protocol import (
    ENV_ENABLED,
    ENV_MEMBER,
    ENV_MEMBERS,
    ENV_POLL,
    ENV_SHADOW,
    ElasticController,
    ElasticJournal,
    ElasticSettings,
    GenerationRecord,
    active_controller,
    elastic_dir,
    generation_path,
    install,
    install_from_env,
    journal_files,
    journal_path,
    read_generation,
    read_history,
    read_journal,
    uninstall,
    write_generation,
)

_LAZY = {
    "ElasticBatchStream": ("tony_tpu_torch.elastic.data", "ElasticBatchStream"),
    "reference_batches": ("tony_tpu_torch.elastic.data", "reference_batches"),
    "ShadowStore": ("tony_tpu_torch.elastic.shadow", "ShadowStore"),
    "reshard_state": ("tony_tpu_torch.elastic.shadow", "reshard_state"),
    "ElasticTopology": ("tony_tpu_torch.elastic.topology", "ElasticTopology"),
}


def __getattr__(name: str):
    # lazy torch-side exports: a control-plane process imports this package
    # for the protocol alone and must not load torch
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


__all__ = [
    "ENV_ENABLED",
    "ENV_MEMBER",
    "ENV_MEMBERS",
    "ENV_POLL",
    "ENV_SHADOW",
    "ElasticBatchStream",
    "ElasticController",
    "ElasticJournal",
    "ElasticSettings",
    "ElasticTopology",
    "GenerationRecord",
    "ShadowStore",
    "active_controller",
    "elastic_dir",
    "generation_path",
    "install",
    "install_from_env",
    "journal_files",
    "journal_path",
    "read_generation",
    "read_history",
    "read_journal",
    "reference_batches",
    "reshard_state",
    "uninstall",
    "write_generation",
]
