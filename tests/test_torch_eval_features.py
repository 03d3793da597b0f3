"""The port's ``eval/features.py`` against the JAX package's on the CPU: every
feature family on seeded grids (1e-12), the drop-column list, and the
features table against JAX's pandas DataFrame: the same index, columns and
values, the CSV file the same text as pandas' ``to_csv``, and after the
media pass's drops the same rows and columns in ``to_html``;
``get_stats_from_evaluator``."""

import io
import re
import types

import numpy as np
import pandas as pd
import pytest

from transformergrooveinfilling_tpu.eval import features as JF
from transformergrooveinfilling_tpu_torch.eval import features as F

STYLES = ["funk", "rock", "jazz", "latin"]


def _grids(rng, n, t=32):
    h = (rng.random((n, t, 9)) < 0.3).astype(np.float32)
    return np.concatenate([h, h * rng.random((n, t, 9)), h * (rng.random((n, t, 9)) - 0.5)],
                          -1).astype(np.float32)


def _case(rng, n=24):
    gt, pred = _grids(rng, n), _grids(rng, n)
    tags = [STYLES[i] for i in rng.integers(0, len(STYLES), n)]
    return gt, pred, tags


@pytest.mark.parametrize("t", [16, 32, 48])
def test_feature_families_match_jax(rng, t):
    gt, pred = _grids(rng, 20, t), _grids(rng, 20, t)
    assert list(F.ALL_FAMILIES) == list(JF.ALL_FAMILIES)
    for fam in F.ALL_FAMILIES:
        kwargs = {"reference_hvo": gt} if fam == "Statistical" else {}
        got, want = F.ALL_FAMILIES[fam](pred, **kwargs), JF.ALL_FAMILIES[fam](pred, **kwargs)
        assert list(got) == list(want), fam
        for name in want:
            assert got[name].dtype == want[name].dtype, (fam, name)
            np.testing.assert_allclose(got[name], want[name], rtol=1e-12, atol=1e-12,
                                       err_msg=f"{fam}::{name}")
    row = (gt[..., 2] > 0).astype(np.float32)
    np.testing.assert_allclose(F.lhl_syncopation(row), JF.lhl_syncopation(row), atol=1e-12)
    np.testing.assert_allclose(F.witek_polyphonic_syncopation(gt[..., :9]),
                               JF.witek_polyphonic_syncopation(gt[..., :9]), atol=1e-12)
    np.testing.assert_allclose(F.vel_similarity_score(pred, gt),
                               JF.vel_similarity_score(pred, gt), atol=1e-12)
    assert F.INFILLING_DROP_COLUMNS == JF.INFILLING_DROP_COLUMNS


def test_features_table_matches_jax_dataframe(rng, tmp_path):
    gt, pred, tags = _case(rng)
    table, df = F.features_table(gt, pred, tags), JF.features_table(gt, pred, tags)
    assert table.index == list(df.index) and table.columns == list(df.columns)
    for c in df.columns:
        np.testing.assert_allclose(table[c], df[c].to_numpy(), rtol=1e-12, atol=1e-12)

    # a NaN cell writes as pandas writes it: an empty cell, and dropna drops its column
    col = table.columns[3]
    table._columns[col][1] = float("nan")
    df.loc[df.index[1], col] = float("nan")
    table.to_csv(str(tmp_path / "port.csv"))
    want = io.StringIO()
    df.to_csv(want)
    got = (tmp_path / "port.csv").read_text()
    assert got == want.getvalue()
    back = pd.read_csv(tmp_path / "port.csv", index_col=0, float_precision="round_trip")
    pd.testing.assert_frame_equal(back, df, check_exact=True)

    dropped = table.drop(columns=[c for c in F.INFILLING_DROP_COLUMNS if c in table.columns])
    dropped = dropped.dropna(axis=1)
    df = df.drop(columns=[c for c in JF.INFILLING_DROP_COLUMNS if c in df.columns])
    df = df.dropna(axis=1)
    assert dropped.columns == list(df.columns) and col not in dropped.columns

    # the header cells: the columns, then the row labels, in order
    assert re.findall(r"<th>(.*?)</th>", dropped.to_html()) == re.findall(
        r"<th>(.*?)</th>", df.to_html())
    with pytest.raises(KeyError):
        table.drop(columns=["no such column"])


def test_get_stats_from_evaluator_matches_jax(rng, tmp_path):
    gt, pred, tags = _case(rng, 30)
    ev = types.SimpleNamespace(_gt_hvos_array=gt, _prediction_hvos_array=pred,
                               _gt_hvos_array_tags=tags)
    table = F.get_stats_from_evaluator(ev, csv_file=str(tmp_path / "a" / "stats.csv"))
    df = JF.get_stats_from_evaluator(ev, csv_file=str(tmp_path / "b" / "stats.csv"))
    assert table.index == list(df.index) and table.columns == list(df.columns)
    assert (tmp_path / "a" / "stats.csv").read_text() == (tmp_path / "b" / "stats.csv").read_text()
    # GT against itself scores exactly 1 on the similarity feature
    assert np.all(table["Statistical::Vel Similarity Score__Ground_Truth"] == 1.0)
