"""Layouts over a world of ranks, one process per device (counterpart of
``dasac_tpu/core/mesh.py`` and of the layout rules of
``dasac_tpu/infer/engine.infer_mesh`` and ``dasac_tpu/train/loop.py``).

Training (:func:`train_mesh`, :func:`train_groups`): a
:class:`TrainLayout` ``(n_data, n_sp)`` of ``make_mesh_2d``'s shape, its
``sp`` and ``data`` groups built on every rank.

Inference:

A layout is ``(n_data, n_sp, b)``: ``n_data`` frames run side by side,
each over ``n_sp`` ranks that split its height (``n_sp`` 0 in batch mode,
as in ``dasac_tpu``), and ``b`` frames make a global batch.  Rank ``r``
is ``(d, s) = divmod(r, max(n_sp, 1))``: the ``sp`` ranks of a frame are
adjacent, as ``dasac_tpu``'s ``reshape(n_data, n_sp)`` of the device list
makes them.  Ranks past ``n_data * max(n_sp, 1)`` sit the layout out.
"""

from typing import NamedTuple

import torch.distributed as tdist

from dasac_tpu_torch.core import dist


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


# ---------------------------------------------------------------------------
# training over a (data, sp) world (``TPU.PARTITION`` gspmd)
# ---------------------------------------------------------------------------

class TrainLayout(NamedTuple):
    """A training world of ``n_data * n_sp`` ranks: ``n_data`` slices of
    the global batch, each frame's height over ``n_sp`` ranks (1: whole
    frames).  ``gspmd``: the ranks run the global-batch step together
    (``dasac_tpu``'s ``gspmd_train_step``); otherwise each runs its own
    shard_map-style share."""

    n_data: int
    n_sp: int = 1
    gspmd: bool = False

    @property
    def ranks(self):
        return self.n_data * self.n_sp

    def coords(self, rank):
        """``(d, s)`` of ``rank``: the ``sp`` ranks of a slice are
        adjacent (``make_mesh_2d``'s ``reshape(n_data, n_sp)``)."""
        return divmod(rank, self.n_sp)


def _check_batch(cfg, n_data, what):
    for name, v in (("TRAIN.BATCH_SIZE", cfg.TRAIN.BATCH_SIZE),
                    ("TRAIN.NUM_GROUPS", cfg.TRAIN.NUM_GROUPS)):
        if v % n_data:
            raise ValueError("{}={} must be divisible by the {}".format(
                name, v, what))


def train_mesh(cfg, available, world=None, n_local=None):
    """The :class:`TrainLayout` ``cfg`` asks for, by the rules of
    ``dasac_tpu/train/loop.py:39-77``.

    Without ``world`` (the ranks are still to be spawned on this host):
    ``TPU.MESH_DEVICES`` ranks, where 0 means as many of ``available``
    devices as divide both batch dimensions (under gspmd: ``MESH_SP``
    times that count of ``available // MESH_SP``).  With ``world`` (a
    world already joined) the layout spans it, and under gspmd each
    ``sp`` group must lie inside one host: ``MESH_SP`` divides
    ``n_local``, the ranks a host runs.  ``TPU.MESH_SP`` counts under
    gspmd only, as in ``dasac_tpu``.  Raises ``ValueError`` naming the
    quantities that do not divide."""
    tpu = cfg.TPU
    gspmd = tpu.PARTITION == "gspmd"
    if not gspmd:
        n_dev = world or tpu.MESH_DEVICES or dist.auto_mesh_size(
            available, cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.NUM_GROUPS)
        _check_batch(cfg, n_dev, "{}-device mesh".format(n_dev))
        return TrainLayout(n_dev, 1, False)
    n_sp = max(1, int(tpu.MESH_SP))
    if world:
        n_dev = world
        if n_local and n_local % n_sp:
            raise ValueError(
                "TPU.MESH_SP=%d must divide the %d local devices per "
                "process (sp halo exchanges must not cross hosts)"
                % (n_sp, n_local))
    else:
        n_dev = tpu.MESH_DEVICES or n_sp * dist.auto_mesh_size(
            available // n_sp, cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.NUM_GROUPS)
    if n_dev % n_sp:
        raise ValueError("TPU.MESH_DEVICES=%d must be divisible by "
                         "TPU.MESH_SP=%d" % (n_dev, n_sp))
    n_data = n_dev // n_sp
    _check_batch(cfg, n_data, "{}-way data axis of the {}-device gspmd "
                 "mesh".format(n_data, n_dev))
    return TrainLayout(n_data, n_sp, True)


class TrainGroups(NamedTuple):
    """This rank's process groups in a :class:`TrainLayout`: ``world``
    (every rank), ``sp`` (the ranks of its data slice, which split each
    frame's height; ``None`` when ``n_sp`` is 1) and ``data`` (the ranks
    holding the same rows of every slice; ``None`` when ``n_data`` is
    1), with its coordinates ``(d, s)``."""

    world: object
    sp: object
    data: object
    d: int
    s: int
    n_data: int
    n_sp: int


def train_groups(layout, rank, world_group):
    """Build the ``sp`` and ``data`` groups of ``layout`` (every rank of
    the world calls it, with the same layout: each creates every group in
    the same order) and return this rank's :class:`TrainGroups`.  A
    barrier on each group the rank joins sets its communicator up on all
    of its ranks at once."""
    d, s = layout.coords(rank)
    sp = data = None
    if layout.n_sp > 1:
        for dd in range(layout.n_data):
            g = tdist.new_group(list(range(dd * layout.n_sp,
                                           (dd + 1) * layout.n_sp)))
            if dd == d:
                sp = g
    if layout.n_data > 1 and layout.n_sp > 1:
        for ss in range(layout.n_sp):
            g = tdist.new_group(list(range(ss, layout.ranks, layout.n_sp)))
            if ss == s:
                data = g
    elif layout.n_data > 1:
        data = world_group
    for g in (sp, data):
        if g is not None and g is not world_group:
            tdist.barrier(group=g)
    return TrainGroups(world_group, sp, data, d, s, layout.n_data,
                       layout.n_sp)
