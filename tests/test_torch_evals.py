"""The port's evals (osu_diffusion_tpu_torch/evals/, tools/style_separation.py)
against the JAX package's, on the CPU.

The model is tests/torch_serving_setup.py's (hidden 32, depth 4, 7 classes,
the same weights on both sides through `state_dict_from_jax_params`); the
port runs its plain versions in f32, and JAX's draws are fed to the port
(`z` and `noise_fn`). Tolerances:
- examples, fuckups, scores and the analytics: equal (exact);
- in-painted predictions (normalized to the playfield): DDIM chains within
  CHAIN_TOL = 5e-3 of JAX's; ancestral chains by their pinned rows, which
  end exactly at known_x (the t = 0 step's mean is x0 there), and within
  CHAIN_TOL of JAX's over the seeds below (an ancestral chain's first step
  scales f32 ordering differences by ~1e4 before the clamp, so single
  elements of small CPU chains have crossed 5e-3 with no fault: the
  seeds here were not chosen, they are the first ones tried);
- pattern repair (t = 0 steps, deterministic given the model): CHAIN_TOL,
  at T <= 128 (full attention in JAX, the band covering every key in the
  port) and at T = 150 (JAX's dense banded mask, the port's band over the
  128-row bucket's padding).
Scoring is held on JAX's own predictions: the JAX suite runs with its
predictions recorded, the port's suite is handed them, and the dicts must
be equal, so no prediction near GOOD_RADIUS_PX can flip the comparison.
"""
import io
import json
import os
import pickle
import runpy
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from osu_diffusion_tpu.beatmap import Beatmap as JaxBeatmap
from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
from osu_diffusion_tpu.evals import distances as jax_dist
from osu_diffusion_tpu.evals import embeddings as jax_emb
from osu_diffusion_tpu.evals import plot_loss as jax_plot
from osu_diffusion_tpu.evals import tooling as jax_tool
from osu_diffusion_tpu.evals import toy as jax_toy
from osu_diffusion_tpu.evals import unfuck as jax_unfuck
from osu_diffusion_tpu.sampling import Sampler as JaxSampler
from osu_diffusion_tpu_torch.beatmap import Beatmap
from osu_diffusion_tpu_torch.beatmap.parser import parse_beatmap
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
from osu_diffusion_tpu_torch.evals import distances, embeddings, plot_loss, tooling, toy, unfuck
from osu_diffusion_tpu_torch.models.dit import DiT, DiT_models
from osu_diffusion_tpu_torch.sampling import Sampler
from osu_diffusion_tpu_torch.tools import style_separation
from osu_diffusion_tpu_torch.utils.logger import create_logger
from torch_serving_setup import CHAIN_TOL, CLASSES, jax_model, jax_noise, port_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets", "toy_datasets")
KIMI = os.path.join(ASSETS, "kimi_no_bouken.osu")
STEPS = 4
N_PRED = 3


@pytest.fixture(scope="module")
def models():
    jm, params = jax_model()
    return jm, params, port_model(params)


def _fixture(suite, i=0):
    return os.path.join(ASSETS, suite, sorted(os.listdir(os.path.join(ASSETS, suite)))[i])


# -- examples and fuckups ----------------------------------------------------


@pytest.mark.parametrize("seq_len", [None, 128, 16])  # 16: the longer fixtures are trimmed
def test_toy_examples_equal_jax(seq_len):
    got = toy.load_example_folder("visual_spacing", seq_len)
    want = jax_toy.load_example_folder("visual_spacing", seq_len)
    assert len(got) == len(want) == 13
    assert max(len(seq) for seq, _ in toy.load_example_folder("visual_spacing", None)) > 16
    for (seq, label), (jseq, jlabel) in zip(got, want):
        np.testing.assert_array_equal(seq, jseq)
        np.testing.assert_array_equal(label, jlabel)
        if seq_len is not None:
            assert seq.shape[0] == seq_len


@pytest.mark.parametrize("seq_len", [None, 128, 16])
def test_unfuck_examples_and_fuckups_equal_jax(seq_len):
    """Every symmetry fixture and kimi (757 rows, longer than every seq_len
    here: the span's start clamps at 0), fucked up by one numpy stream on
    each side."""
    filler, jfiller = toy.load_filler_seq(), jax_toy.load_filler_seq()
    np.testing.assert_array_equal(filler, jfiller)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    paths = [_fixture("symmetry", i) for i in range(12)] + [KIMI]
    for path in paths:
        seq, start, end = unfuck.example_from_beatmap(Beatmap.from_path(path), seq_len, filler)
        jseq, jstart, jend = jax_unfuck.example_from_beatmap(JaxBeatmap.from_path(path), seq_len,
                                                             jfiller)
        np.testing.assert_array_equal(seq, jseq)
        assert (start, end) == (jstart, jend) and start >= 0
        np.testing.assert_array_equal(unfuck.fuckup_pattern(seq, start, end, 5.0, rng),
                                      jax_unfuck.fuckup_pattern(jseq, jstart, jend, 5.0, jrng))
    if seq_len is not None:
        assert (start, end) == (0, seq_len)  # kimi, trimmed


# -- in-painted predictions --------------------------------------------------


class Recorder:
    """A sampler that keeps each call's output and in-painting inputs."""

    def __init__(self, sampler):
        self.sampler, self.model, self.calls = sampler, sampler.model, []

    def __call__(self, *args, **kwargs):
        out = self.sampler(*args, **kwargs)
        self.calls.append((out, kwargs["known_x"], kwargs["known_mask"]))
        return out


def _predictions(models, method, seed, seq):
    """(port, JAX) predictions of one example with JAX's draws, and the
    port's recorded call."""
    jm, params, port = models
    jd = jax_create(str(STEPS), noise_schedule="squaredcos_cap_v2")
    pd = create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2")
    rng = jax.random.PRNGKey(seed)
    want = jax_toy.generate_predictions(JaxSampler(jm, jd, band=128, method=method), params, seq,
                                        N_PRED, CLASSES, rng)
    noise_rng, sample_rng = jax.random.split(rng)
    z = torch.from_numpy(np.array(jax.random.normal(noise_rng, (N_PRED, seq.shape[0], 2))))
    sampler = Recorder(Sampler(port, pd, band=128, method=method))
    got = toy.generate_predictions(sampler, seq, N_PRED, CLASSES, noise_fn=jax_noise(sample_rng, STEPS),
                                   z=z)
    return got, want, sampler.calls[0]


def _check_pinned(call, seq):
    out, known_x, free = (a.numpy() for a in call)
    assert free[:, -1].all() and not free[:, :-1].any()
    np.testing.assert_array_equal(out[~free], known_x[~free])
    np.testing.assert_array_equal(known_x[0], seq[:, :2] / toy.PLAYFIELD)


@pytest.mark.parametrize("seq_len", [None, 128])
def test_generate_predictions_ddim_matches_jax(models, seq_len):
    seq, _ = toy.load_example_folder("geometry", seq_len)[3]
    got, want, call = _predictions(models, "ddim", 0, seq)
    assert got.shape == want.shape == (N_PRED, 2)
    np.testing.assert_allclose(got / toy.PLAYFIELD, want / toy.PLAYFIELD, atol=CHAIN_TOL)
    _check_pinned(call, seq)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_predictions_ancestral_matches_jax(models, seed):
    seq, _ = toy.load_example_folder("stream", 128)[seed]
    got, want, call = _predictions(models, "ancestral", seed, seq)
    _check_pinned(call, seq)
    np.testing.assert_allclose(got / toy.PLAYFIELD, want / toy.PLAYFIELD, atol=CHAIN_TOL)


# -- pattern repair ----------------------------------------------------------


@pytest.mark.parametrize("seq_len", [None, 150])  # T = 22 (full attention), T = 150 (band 128)
def test_unfuck_pattern_matches_jax(models, seq_len):
    jm, params, port = models
    filler = toy.load_filler_seq()
    seq, start, end = unfuck.example_from_beatmap(Beatmap.from_path(_fixture("symmetry", 5)),
                                                  seq_len, filler)
    assert seq.shape[0] == (seq_len or 22) and end - start == 22
    fucked = unfuck.fuckup_pattern(seq, start, end, 5.0, np.random.default_rng(0))
    rng = jax.random.PRNGKey(7)
    want = jax_unfuck.unfuck_pattern(jm, jax_create(None, noise_schedule="squaredcos_cap_v2"),
                                     params, fucked, start, end, N_PRED, STEPS, CLASSES, rng)
    got = unfuck.unfuck_pattern(port, create_diffusion(None, noise_schedule="squaredcos_cap_v2"),
                                fucked, start, end, N_PRED, STEPS, CLASSES,
                                noise_fn=jax_noise(rng, STEPS, t_real=seq.shape[0]))
    assert got.shape == want.shape == (N_PRED, end - start, 2)
    assert not np.allclose(got, fucked[None, start:end, :2], atol=1e-2)  # the span moved
    np.testing.assert_allclose(got / toy.PLAYFIELD, want / toy.PLAYFIELD, atol=CHAIN_TOL)


# -- scoring on JAX's predictions ---------------------------------------------


def _recording(fn, record):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        record.append((args, out))
        return out

    return wrapped


def _replaying(record, check_args):
    calls = iter(record)

    def fake(*args, **kwargs):
        jargs, out = next(calls)
        check_args(args, jargs)
        return out

    return fake


@pytest.mark.parametrize("shift", [None, "radius"])
def test_toy_scoring_on_jax_predictions(models, monkeypatch, shift):
    """`shift="radius"`: JAX's predictions replaced by points 29-31 px from
    the label in both suites, so the counts straddle GOOD_RADIUS_PX."""
    jm, params, port = models
    record = []
    gen = _recording(jax_toy.generate_predictions, record)
    if shift == "radius":
        r = np.random.RandomState(0)

        def gen(sampler, params, seq, n, num_classes, rng):  # noqa: F811
            angle = r.rand(n) * 2 * np.pi
            pts = seq[-1, :2] + (29 + 2 * r.rand(n))[:, None] * np.stack(
                [np.cos(angle), np.sin(angle)], 1)
            record.append(((sampler, params, seq), pts.astype(np.float32)))
            return pts.astype(np.float32)

    monkeypatch.setattr(jax_toy, "generate_predictions", gen)
    jd = jax_create("2", noise_schedule="squaredcos_cap_v2")
    want = jax_toy.evaluate_suite(JaxSampler(jm, jd, band=128), params, "symmetry", 2, CLASSES,
                                  128, jax.random.PRNGKey(0))

    def same_seq(args, jargs):
        np.testing.assert_array_equal(args[1], jargs[2])

    monkeypatch.setattr(toy, "generate_predictions", _replaying(record, same_seq))
    got = toy.evaluate_suite(None, "symmetry", 2, CLASSES, 128)
    assert got == want and got["total"] == 24
    if shift == "radius":
        assert 0 < got["good"] < got["total"]


def test_unfuck_scoring_on_jax_predictions(models, monkeypatch):
    jm, params, port = models
    record = []
    monkeypatch.setattr(jax_unfuck, "unfuck_pattern",
                        _recording(jax_unfuck.unfuck_pattern, record))
    # seq_len 32: one length, so JAX compiles its chain once
    want = jax_unfuck.evaluate_suite(jm, jax_create(None), params, "symmetry", 2, 2, CLASSES, 32,
                                     5.0, jax.random.PRNGKey(0))

    def same_inputs(args, jargs):
        np.testing.assert_array_equal(args[2], jargs[3])  # seq_fucked
        assert args[3:5] == jargs[4:6]  # start, end

    monkeypatch.setattr(unfuck, "unfuck_pattern", _replaying(record, same_inputs))
    got = unfuck.evaluate_suite(None, None, "symmetry", 2, 2, CLASSES, 32, 5.0)
    assert got == want and got["num_predictions"] > 0


# -- the CLIs on the CPU -----------------------------------------------------


def _tiny(**kwargs):
    return DiT(hidden_size=32, depth=2, num_heads=2, **kwargs)


@pytest.fixture
def tiny_ckpt(tmp_path, monkeypatch):
    monkeypatch.setitem(DiT_models, "DiT-T", _tiny)
    torch.manual_seed(0)
    model = _tiny(num_classes=CLASSES)
    ckpt = str(tmp_path / "tiny.pt")
    torch.save({"ema": model.state_dict()}, ckpt)
    return ckpt


def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("quantize", [False, True])
def test_toy_cli(tiny_ckpt, quantize):
    """Suites, then --generate, whose lines parse as the fixture's hit
    objects."""
    common = ["--ckpt", tiny_ckpt, "--model", "DiT-T", "--num-classes", str(CLASSES),
              "--num-sampling-steps", "2", "--num-predictions", "2", "--device", "cpu",
              "--accel-interval", "2"] + (["--quantize-weights"] if quantize else [])
    out = _run(toy.main, common + ["--tests", "symmetry"])
    assert "symmetry\nCorrect predictions = " in out and "/24)" in out
    assert "full model steps = 2/2" in out
    fixture = os.path.join("stream", sorted(os.listdir(os.path.join(ASSETS, "stream")))[0])
    out = _run(toy.main, common + ["--generate", fixture, "--seq-len", "128"])
    lines = out.splitlines()
    assert lines[0].startswith("Generate example correct predictions = ")
    with open(os.path.join(ASSETS, fixture)) as f:
        text = f.read()
    head = text[: text.index("[HitObjects]")]
    bm = parse_beatmap(head + "[HitObjects]\n" + "\n".join(lines[1:]) + "\n")
    assert len(bm.hit_objects()) == 2


def test_unfuck_cli(tiny_ckpt):
    out = _run(unfuck.main, ["--ckpt", tiny_ckpt, "--model", "DiT-T", "--num-classes",
                             str(CLASSES), "--num-sampling-steps", "2", "--num-predictions", "2",
                             "--tests", "symmetry", "--device", "cpu"])
    lines = out.splitlines()
    assert lines[0] == "symmetry"
    assert lines[1].startswith("Mean fucked distance = ") and lines[2].startswith(
        "Mean unfucked distance = ")


# -- distances, plot_loss, embeddings, tooling, style separation -------------


def _offset_copy(path, dx):
    bm = Beatmap.from_path(path)
    from osu_diffusion_tpu_torch.beatmap.objects import Position

    for ho in bm._hit_objects:
        ho.position = Position(ho.position.x + dx, ho.position.y)
    return bm


def test_distances_equal_jax(tmp_path):
    ref, jref = Beatmap.from_path(KIMI), JaxBeatmap.from_path(KIMI)
    for i, dx in enumerate([0, 3, -7]):
        _offset_copy(KIMI, dx).write_path(str(tmp_path / f"m{i}.osu"))
    for path in sorted(tmp_path.glob("*.osu")):
        got = distances.compare_spacing(ref, Beatmap.from_path(path))
        want = jax_dist.compare_spacing(jref, JaxBeatmap.from_path(path))
        assert got["mse"] == want["mse"] and got["mae"] == want["mae"]
        np.testing.assert_array_equal(got["delta"], want["delta"])
    assert distances.compare_spacing(ref, Beatmap.from_path(_fixture("stream"))) is None
    argv = ["--ref-beatmap", KIMI, "--beatmap", str(tmp_path)]
    assert _run(distances.main, argv) == _run(jax_dist.main, argv)


def test_parse_losses_reads_the_port_trainers_line(tmp_path):
    """The trainer's own logger and line (train/trainer.py)."""
    logger = create_logger(str(tmp_path))
    for step, loss in [(100, 0.12345), (200, 0.0987), (300, 1.5)]:
        logger.info(f"(step={step:07d}) Train Loss: {loss:.4f}, Train Steps/Sec: {12.3:.2f}")
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    path = str(tmp_path / "log.txt")
    assert plot_loss.parse_losses(path) == jax_plot.parse_losses(path) == [0.1235, 0.0987, 1.5]


def _svm_fixtures(tmp_path):
    """A checkpoint with a style table, beatmap_df.pkl and an omdb tag csv
    (tests/test_evals.py's layout)."""
    pd = pytest.importorskip("pandas", reason="the dataframe analytics need pandas")
    rs = np.random.RandomState(0)
    table = rs.randn(13, 8).astype(np.float32)
    table[6:12] += 8.0
    table[3] += 100.0  # one of Alice's maps an outlier
    ckpt = tmp_path / "ckpt.pt"
    torch.save({"ema": {"y_embedder.embedding_table.weight": torch.from_numpy(table)},
                "model": {"y_embedder.embedding_table.weight": torch.zeros(13, 8)}}, ckpt)
    rows = [{"BeatmapID": 100 + i, "Title": f"song{i}", "Creator": "Alice" if i < 6 else "Bob",
             "Difficulty": "Expert"} for i in range(12)]
    rows.append({"BeatmapID": 200, "Title": "guest", "Creator": "Bob",
                 "Difficulty": "Alice's Extra"})
    df_path = tmp_path / "beatmap_df.pkl"
    pd.DataFrame(rows).to_pickle(df_path)
    csv_path = tmp_path / "omdb_tags.csv"
    csv_path.write_text("\n".join([f"{100 + i},geometric" for i in range(6)]
                                  + [f"{100 + i},freeform" for i in range(6, 12)]) + "\n")
    idx_path = tmp_path / "idx.pickle"
    with open(idx_path, "wb") as f:
        pickle.dump({100 + i: i for i in range(13)}, f)
    return str(ckpt), str(df_path), str(csv_path), str(idx_path), table


def test_embedding_functions_equal_jax():
    pytest.importorskip("sklearn", reason="the SVM and t-SNE need sklearn")
    table = np.random.RandomState(0).randn(20, 8).astype(np.float32)
    idx = {100 + i: i for i in range(20)}
    for fn in ("find_similar", "find_nearest"):
        assert getattr(embeddings, fn)(table, idx, 105, k=3) == getattr(jax_emb, fn)(
            table, idx, 105, k=3)
    g0, g1 = np.arange(10), np.arange(10, 20)
    for fn in ("mean_distance_to_group", "group_uniqueness"):
        np.testing.assert_array_equal(getattr(embeddings, fn)(table, g1),
                                      getattr(jax_emb, fn)(table, g1))
    table2 = table.copy()
    table2[g1] += 1.0
    clf, jclf = embeddings.fit_tag_svm(table2, [g0, g1]), jax_emb.fit_tag_svm(table2, [g0, g1])
    for group, label in ((g0, 0), (g1, 1), (g1, 0)):
        assert embeddings.svm_accuracy(clf, table2, group, label) == jax_emb.svm_accuracy(
            jclf, table2, group, label)
    big = np.random.RandomState(1).randn(40, 8).astype(np.float32)  # perplexity 30 < rows
    np.testing.assert_array_equal(embeddings.tsne_embeddings(big, 39, n_iter=250),
                                  jax_emb.tsne_embeddings(big, 39, n_iter=250))


@pytest.mark.parametrize("cmd", [
    ["svm", "--tags", "geometric", "freeform", "--test-tags", "geometric", "--test-mappers",
     "Alice"],
    ["svm", "--mappers", "Alice", "Bob"],
    ["unique", "--mapper", "Alice", "-k", "2"],
    ["similar", "--beatmap-id", "104", "-k", "3"],
    ["similar", "--beatmap-id", "104", "-k", "3", "--nearest"],
    ["print"],
])
def test_embedding_cli_equals_jax(tmp_path, cmd):
    pytest.importorskip("sklearn", reason="the SVM needs sklearn")
    ckpt, df_path, csv_path, idx_path, table = _svm_fixtures(tmp_path)
    extra = {"svm": ["--beatmap-df", df_path, "--tags-csv", csv_path],
             "unique": ["--beatmap-df", df_path], "similar": ["--beatmap-idx", idx_path],
             "print": []}[cmd[0]]
    argv = cmd[:1] + ["--ckpt", ckpt] + extra + cmd[1:]
    got = _run(embeddings.main, argv)
    assert got == _run(jax_emb.main, argv) and got.strip()
    np.testing.assert_array_equal(embeddings.load_embedding_table(ckpt), table)


def test_embedding_table_refuses_an_orbax_directory(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        embeddings.load_embedding_table(str(tmp_path))


def test_tooling_equals_jax(tmp_path):
    for i in range(3):
        track = tmp_path / f"Track{i:05d}"
        track.mkdir()
        beatmaps = {}
        for j in range(2):
            idx = i * 2 + j
            beatmaps[f"{idx:06d}M{j:03d}"] = {
                "BeatmapId": 1000 + idx % 5, "Ruleset": 0, "MD5Hash": "x",
                "Difficulty": f"d{j}", "OnlineOffset": 0, "DrainTime": 60,
                "TotalTime": 70, "RankedStatus": 4, "CirclesCount": 10,
                "SpinnersCount": 0, "SlidersCount": 5, "CircleSize": 4,
                "ApproachRate": 9, "OverallDifficulty": 8, "HPDrain": 5,
                "SliderVelocity": 1.4, "StackLeniency": 0.7,
                "StandardStarRating": {"0": 5.5 + idx},
            }
        (track / "metadata.json").write_text(json.dumps({
            "BeatmapSetId": 2000 + i, "Artist": "a", "Title": "t", "Creator": "c",
            "Source": "", "Tags": "", "Beatmaps": beatmaps}))
    assert tooling.build_beatmap_idx(str(tmp_path), 4) == jax_tool.build_beatmap_idx(str(tmp_path), 4)
    pytest.importorskip("pandas", reason="the dataframe tooling needs pandas")
    df = tooling.build_beatmap_dataframe(str(tmp_path), 4)
    assert df.equals(jax_tool.build_beatmap_dataframe(str(tmp_path), 4)) and len(df) == 6
    res, jres = tooling.validate_beatmap_dataframe(df), jax_tool.validate_beatmap_dataframe(df)
    assert res["unique_ids"] == jres["unique_ids"] == 5 and res["duplicates"].equals(jres["duplicates"])
    for cmd in (["idx", "--dataset-path", str(tmp_path), "--num-tracks", "4"],
                ["dataframe", "--dataset-path", str(tmp_path), "--num-tracks", "4"]):
        a, b = tmp_path / "port.out", tmp_path / "jax.out"
        _run(tooling.main, cmd + ["--out", str(a)])
        _run(jax_tool.main, cmd + ["--out", str(b)])
        assert a.read_bytes() == b.read_bytes()
    argv = ["validate", "--dataframe", str(tmp_path / "port.out")]
    assert _run(tooling.main, argv) == _run(jax_tool.main, argv)


def test_style_separation_equals_jax(tmp_path, monkeypatch, capsys):
    """The port's tool and tools/style_separation.py on the same outputs:
    three styles, two variants each (offset copies of a fixture)."""
    for style, dx in ((3, 0), (5, 20), (9, -40)):
        for i in range(2):
            _offset_copy(_fixture("stream"), dx + i).write_path(
                str(tmp_path / f"1 result {style} {i}.osu"))
    pattern = str(tmp_path / "*.osu")
    style_separation.main(["--pattern", pattern])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["style_separation.py", "--pattern", pattern])
    runpy.run_path(os.path.join(ROOT, "tools", "style_separation.py"), run_name="__main__")
    want = capsys.readouterr().out
    assert got == want and json.loads(got)["styles"] == ["3", "5", "9"]
