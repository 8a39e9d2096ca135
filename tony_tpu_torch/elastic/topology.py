"""ElasticTopology: member-granular meshes over torch.distributed ranks.
The counterpart of ``tony_tpu/elastic/topology.py``.

The unit of elasticity is a **member**: one gang seat owning an equal
share of the job. The reference counts a member's devices, which its one
controller process owns; the port runs one process per rank, so a member
is ``per_member.n_devices`` consecutive ranks of the full-strength world,
member-major on ``dp``, as the reference's ``mesh_for`` orders devices.
Members map onto the ``dp`` axis outermost: parameters and optimizer
state are replicated across members (sharded only over the per-member
axes inside a member's ranks), which is what makes survivors whole.

:meth:`shape_for` gives the mesh shape of a live membership: ``dp`` is
the member count, the per-member shape is kept. The world of a
generation is its members' ranks, renumbered member-major in member
order (:meth:`rank_of` with ``members``), so the dp coordinate is a
member's place among the survivors; ``fit()`` re-forms the process group
over that world at each generation boundary (``train/loop.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from tony_tpu_torch.parallel.mesh import MeshShape


@dataclass
class ElasticTopology:
    """Partition of a ``world`` of ranks into ``n_members`` equal groups.

    ``per_member`` is the mesh shape INSIDE one member's ranks; its ``dp``
    must be 1 (the dp axis is the member axis). ``world`` is the
    full-strength rank count (the default group's size when not given).
    """

    n_members: int
    per_member: MeshShape | None = None
    world: int = 0

    def __post_init__(self) -> None:
        if self.n_members < 2:
            raise ValueError(
                f"elastic topology needs >= 2 members, got {self.n_members}"
            )
        if not self.world:
            from tony_tpu_torch.parallel.dist import world

            self.world = world()[1]
        if self.world % self.n_members:
            raise ValueError(
                f"{self.world} ranks not divisible into "
                f"{self.n_members} member groups"
            )
        per = self.world // self.n_members
        if self.per_member is None:
            # fsdp-first inside the member, mirroring default_shape()
            self.per_member = MeshShape(fsdp=per)
        if self.per_member.dp != 1:
            raise ValueError(
                "per_member.dp must be 1: the dp axis is the member axis "
                f"(got per-member shape {self.per_member.sizes})"
            )
        if self.per_member.n_devices != per:
            raise ValueError(
                f"per-member shape {self.per_member.sizes} needs "
                f"{self.per_member.n_devices} devices but each of the "
                f"{self.n_members} members owns {per}"
            )

    @property
    def ranks_per_member(self) -> int:
        return self.world // self.n_members

    def member_of(self, rank: int) -> tuple[int, int]:
        """(member, local index) of a full-strength ``rank``."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside 0..{self.world - 1}")
        return divmod(rank, self.ranks_per_member)

    def rank_of(self, member: int, local: int = 0,
                members: tuple[int, ...] | list[int] | None = None) -> int:
        """The rank of ``member``'s ``local``-th rank: in the full-strength
        world, or with ``members`` in the world of that live membership
        (its place among them, member-major)."""
        if not 0 <= member < self.n_members:
            raise ValueError(f"member {member} outside 0..{self.n_members - 1}")
        if not 0 <= local < self.ranks_per_member:
            raise ValueError(f"local rank {local} outside 0..{self.ranks_per_member - 1}")
        place = member if members is None else sorted(members).index(member)
        return place * self.ranks_per_member + local

    def shape_for(self, members: tuple[int, ...] | list[int]) -> MeshShape:
        if not members:
            raise ValueError("elastic mesh needs at least one live member")
        pm = self.per_member
        return MeshShape(
            dp=len(members), pp=pm.pp, fsdp=pm.fsdp, ep=pm.ep, tp=pm.tp,
            sp=pm.sp,
        )


__all__ = ["ElasticTopology"]
