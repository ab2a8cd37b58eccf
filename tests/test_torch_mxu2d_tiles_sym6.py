"""``tests/test_torch_mxu2d_tiles.py``'s replay of K9 against its plain
versions for sym6 periodic on 384 x 768, in a file of its own so that the test run spreads
the slow replays over its workers."""

from __future__ import annotations

from test_torch_mxu2d_tiles import case_params, check_replay
from _torch_one_thread import one_torch_thread  # noqa: F401


@case_params([4])
def test_replay_matches_plain(shape, bank, mode):
    check_replay(shape, bank, mode)
