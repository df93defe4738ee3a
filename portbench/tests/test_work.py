"""The useful work of an epoch, against counts made by hand."""

from portbench.harness import work


def test_half_step_by_hand():
    # 3 interactions, 2 rows solved against 4, rank 2, float32:
    # 3·(2·4 + 2·2) + 2·(8/3 + 2·4) + 2·4·4 operations
    flops, nbytes = work.half_step(n=2, m=4, nnz=3, k=2, elem=4)
    assert flops == 3 * 12 + 2 * (8 / 3 + 8) + 32
    # ids and value of each interaction, 4 opposite rows read, 2 written
    assert nbytes == 3 * (4 + 4 + 4) + 4 * 2 * 4 + 2 * 2 * 4


def test_epoch_is_both_half_steps():
    config = {"n_users": 5, "n_items": 7, "n_interactions": 11, "rank": 3,
              "dtype": "float32"}
    fu, bu = work.half_step(5, 7, 11, 3, 4)
    fi, bi = work.half_step(7, 5, 11, 3, 4)
    assert work.als_epoch(config) == {"flops": fu + fi, "bytes": bu + bi,
                                      "ratings": 11}


def test_ml20m_epoch():
    config = {"n_users": 138_493, "n_items": 26_744,
              "n_interactions": 20_000_263, "rank": 32, "dtype": "float32"}
    w = work.als_epoch(config)
    # 2·nnz·(2k² + 2k) + rows·(k³/3 + 2k²) + 2·rows·k²
    rows = 138_493 + 26_744
    assert w["flops"] == (2 * 20_000_263 * 2112 + rows * (32 ** 3 / 3 + 2048)
                          + 2 * rows * 1024)
    assert round(w["flops"] / 1e9, 2) == 86.96
    assert w["bytes"] == 2 * 20_000_263 * 12 + 2 * rows * 32 * 4
