"""Data-sheet peaks of the card, by product name: a frozen copy of
``dasac_tpu_torch/tools/bench.py``'s ``BF16_PEAK_TF`` / ``HBM_PEAK_TB_S``.
Dense bf16 tensor-core FLOP/s (no sparsity) and memory bytes/s,
each at the card's full power limit; the first key the card's name
contains wins."""

BF16_PEAK_TF = (("H100 PCIe", 756.5), ("H100 NVL", 835.5), ("H100", 989.4))
HBM_PEAK_TB_S = (("H100 PCIe", 2.0), ("H100 NVL", 3.9), ("H100", 3.35))


def _by_name(table, card):
    return next((v for key, v in table if key in card), None)


def bf16_flops(card):
    """Dense bf16 FLOP/s of ``card`` (``torch.cuda.get_device_name()``),
    None off the table."""
    tf = _by_name(BF16_PEAK_TF, card)
    return None if tf is None else tf * 1e12


def hbm_bytes(card):
    """Memory bytes/s of ``card``, None off the table."""
    tb = _by_name(HBM_PEAK_TB_S, card)
    return None if tb is None else tb * 1e12
