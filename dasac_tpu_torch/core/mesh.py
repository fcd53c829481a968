"""Inference layouts over a world of ranks, one process per device
(counterpart of ``dasac_tpu/core/mesh.py`` and of the layout rules of
``dasac_tpu/infer/engine.infer_mesh``).

A layout is ``(n_data, n_sp, b)``: ``n_data`` frames run side by side,
each over ``n_sp`` ranks that split its height (``n_sp`` 0 in batch mode,
as in ``dasac_tpu``), and ``b`` frames make a global batch.  Rank ``r``
is ``(d, s) = divmod(r, max(n_sp, 1))``: the ``sp`` ranks of a frame are
adjacent, as ``dasac_tpu``'s ``reshape(n_data, n_sp)`` of the device list
makes them.  Ranks past ``n_data * max(n_sp, 1)`` sit the layout out.
"""

from typing import NamedTuple

import torch.distributed as tdist


class Layout(NamedTuple):
    n_data: int
    n_sp: int
    b: int

    @property
    def ranks(self):
        """Ranks the layout uses."""
        return self.n_data * max(self.n_sp, 1)

    def coords(self, rank):
        """``(d, s)`` of ``rank``, or ``None`` for a rank left out."""
        if rank >= self.ranks:
            return None
        return divmod(rank, max(self.n_sp, 1))


def infer_mesh(world, batch_size=None, spatial=0):
    """The :class:`Layout` of ``world`` ranks for a mode, by
    ``dasac_tpu``'s rules.

    ``spatial`` 0/False: batch mode, ``b`` frames over ``min(world, b)``
    ranks (ranks trimmed to a small batch, the batch trimmed DOWN to a
    multiple of the ranks otherwise).  ``spatial`` True/-1: every rank on
    one frame's height.  ``spatial`` N: ``(world / N, N)``, the data axis
    trimmed to a smaller explicit ``batch_size``.  Raises ``ValueError``
    when N does not divide the world."""
    if world < 1:
        raise ValueError("a world has at least one rank, got %d" % world)
    if spatial:
        n_sp = (world if spatial is True or int(spatial) < 0
                else int(spatial))
        if world % n_sp:
            raise ValueError("spatial=%d must divide the %d-rank world"
                             % (n_sp, world))
        n_data = world // n_sp
        if batch_size:
            n_data = min(n_data, batch_size)
        b = batch_size or n_data
        return Layout(n_data, n_sp, max(n_data, (b // n_data) * n_data))
    b = batch_size or world
    n_data = min(world, b)
    return Layout(n_data, 0, (b // n_data) * n_data)


def sp_group(layout, rank):
    """The process group of ``rank``'s frame (its ``n_sp`` adjacent
    ranks), or ``None`` when frames are not split (``n_sp`` < 2) or the
    rank sits out.  Every rank of the world must call it, with the same
    layout: each creates every group, in the same order, and then joins a
    barrier on its own, which sets up the group's communicator on all of
    its ranks at once (NCCL's point-to-point calls that follow may then
    involve only some of them)."""
    if layout.n_sp < 2:
        return None
    mine = None
    for d in range(layout.n_data):
        ranks = list(range(d * layout.n_sp, (d + 1) * layout.n_sp))
        g = tdist.new_group(ranks)
        if rank in ranks:
            mine = g
    if mine is not None:
        tdist.barrier(group=mine)
    return mine
