"""1d transform helpers shared with the 2d transform.

Counterpart of :mod:`ptwt_tpu.conv_transform`; ``wavedec``/``waverec``
are not ported yet, only the odd-length crop bookkeeping that
``waverec2`` uses.
"""

from __future__ import annotations


def _adjust_padding_at_reconstruction(
    res_size: int, coeff_size: int, pad_end: int, pad_start: int
) -> tuple[int, int]:
    """Resolve the odd-length crop ambiguity from the next level's shape.

    If removing the symmetric padding would leave one sample too many,
    crop one extra from the end.
    """
    pred_size = res_size - (pad_start + pad_end)
    if coeff_size == pred_size:
        pass
    elif coeff_size == pred_size - 1:
        pad_end += 1
    else:
        raise AssertionError(
            "padding error, please check if dec and rec wavelets are "
            "identical. (If the analysis used mode='periodization', pass "
            "mode='periodization' to the reconstruction as well — "
            "periodization coefficient chains have different lengths.)"
        )
    return pad_end, pad_start
