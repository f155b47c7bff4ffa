"""`tools/torch_synthfaces_hard.py`, the port's synthfaces_hard acceptance
run, on the CPU: its report on the JAX package's recorded curves, the
quality bars, the resume planners, the config guard, the protocol refusal
and the argv of every entry point the `all` plan calls (with the CLIs'
`main` functions replaced). No InceptionV3 forward and no 2048^2 sqrtm."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

import chip_smoke
from aclgan_tpu_torch.config import load_config, save_config

ROOT = Path(__file__).resolve().parents[1]
RECORDED = ROOT / "docs" / "run_synthfaces_hard"


tool = chip_smoke._acceptance_tool()


def _recorded(prefix):
    return json.loads((RECORDED / f"fid_curve_{prefix}.json").read_text())


def _work_with_curves(tmp_path, docs=None):
    """A work directory holding the recorded curves as if the port wrote them."""
    work = tool.Work.at(tmp_path / "w")
    work.run_dir.mkdir(parents=True)
    for p in tool.PREFIXES:
        (work.curve(p)).write_text(json.dumps(docs[p] if docs else _recorded(p)))
    tool.ensure_config(work, tool.FULL)
    return work


def test_report_on_the_recorded_curves_reproduces_the_run_log(tmp_path):
    """RUNLOG.md's reading of the JAX run: curve means 13.728 (ema) and 15.834
    (gen), the selections ema@3000 at 0.898 and gen@2000 at 2.381, EMA's worst
    after 3k 15.811, every target-domain rate 1.0."""
    work = _work_with_curves(tmp_path)
    s = tool.report(work, tool.FULL, RECORDED, docs=None)
    assert s["gen_against_ema"]["mean_fid"] == {"gen": 15.834, "ema": 13.728}
    assert s["curves"]["ema"]["mean_fid"] == 13.728
    assert s["curves"]["gen"]["mean_fid"] == 15.834
    assert s["curves"]["ema"]["best"] == {"iteration": 3000, "fid": 0.898,
                                          "fid_ci95": [0.0, 6.752]}
    assert s["curves"]["gen"]["best"]["iteration"] == 2000
    assert s["curves"]["gen"]["best"]["fid"] == 2.381
    assert s["curves"]["ema"]["worst_after_3000"] == 15.811
    assert s["curves"]["gen"]["min_rate"] == s["curves"]["ema"]["min_rate"] == 1.0
    assert s["selected"] == {"prefix": "ema", "iteration": 3000, "fid": 0.898}
    for p in tool.PREFIXES:
        rows = s["against_recorded"][p]["rows"]
        assert len(rows) == 20 and all(r["delta"] == 0 for r in rows)
    bars = s["bars"]
    assert bars["target_domain_rate"]["pass"] is True
    assert bars["ema_warmup"]["pass"] is True
    assert bars["ema_warmup"]["value"] == {"ema": 32.865, "gen": 5.611}
    # no classifier and no calibration in this directory: nothing to judge by
    assert bars["classifier_accuracy"]["pass"] is None
    assert bars["best_over_domain_gap"]["pass"] is None
    assert json.loads(work.log("summary").read_text())["selected"]["fid"] == 0.898


def _curve(rows, prefix):
    return {"rows": [{"iteration": it, "fid": fid, "target_domain_rate": rate}
                     for it, fid, rate in rows], "prefix": prefix}


GOOD = {"gen": [(1000, 5.0, 1.0), (2000, 3.0, 1.0), (3000, 6.0, 1.0)],
        "ema": [(1000, 30.0, 1.0), (2000, 8.0, 0.995), (3000, 2.0, 1.0)]}


@pytest.mark.parametrize("case,change,failed", [
    ("all_held", {}, None),
    ("accuracy", {"accuracy": 0.985}, "classifier_accuracy"),
    ("rate_at_2000", {"ema": [(1000, 30.0, 1.0), (2000, 8.0, 0.98), (3000, 2.0, 1.0)]},
     "target_domain_rate"),
    ("rate_before_2000_not_judged", {"gen": [(1000, 5.0, 0.4), (2000, 3.0, 1.0),
                                             (3000, 6.0, 1.0)]}, None),
    ("ema_below_gen_at_1000", {"ema": [(1000, 4.0, 1.0), (2000, 8.0, 1.0),
                                       (3000, 2.0, 1.0)]}, "ema_warmup"),
    ("best_over_gap", {"gap": 7.9}, "best_over_domain_gap"),
    ("best_at_a_quarter_of_gap", {"gap": 8.0}, None),
])
def test_bars_on_hand_made_curves(case, change, failed):
    curves = {p: _curve(change.get(p, GOOD[p]), p) for p in tool.PREFIXES}
    calib = {"domain_gap": change.get("gap", 40.0), "floor": 1.5}
    bars = tool.check_bars(curves, change.get("accuracy", 1.0), calib)
    assert set(bars) == {"classifier_accuracy", "target_domain_rate", "ema_warmup",
                         "best_over_domain_gap"}
    assert {k for k, b in bars.items() if b["pass"] is not True} == (
        {failed} if failed else set()), case
    assert bars["best_over_domain_gap"]["floor"] == 1.5
    assert bars["best_over_domain_gap"]["best_fid"] == 2.0


def test_bars_without_a_warmup_snapshot_fail_it():
    curves = {p: _curve([(2000, 3.0, 1.0)], p) for p in tool.PREFIXES}
    bars = tool.check_bars(curves, 1.0, None)
    assert bars["ema_warmup"]["pass"] is None
    assert bars["best_over_domain_gap"]["pass"] is None


def test_ema_rules_hold_on_the_recorded_jax_curves():
    """The JAX run from 10,000 to 20,000: EMA range 2.889 against the live
    weights' 32.838, median 14.804 against 11.689 (1.2665); the EMA wins 5 of
    those 11 snapshots, and 5 of the 8 from 1,000 to 8,000."""
    curves = {p: _recorded(p) for p in tool.PREFIXES}
    rules = tool.ema_rules(curves)
    assert rules["ema_steadiness"]["value"] == {"ema_range": 2.889, "live_range": 32.838}
    assert rules["ema_level"]["value"] == {"ema_median": 14.804, "live_median": 11.689,
                                           "ratio": 1.2665}
    for name in ("ema_steadiness", "ema_level"):
        assert rules[name]["pass"] is True and rules[name]["snapshots"] == rules[name]["of"] == 11
    assert rules["ema_wins"] == {"ema": 5, "gen": 6, "snapshots": 11}
    fid = {p: {r["iteration"]: r["fid"] for r in curves[p]["rows"]} for p in tool.PREFIXES}
    assert sum(fid["ema"][i] < fid["gen"][i] for i in range(1000, 8001, 1000)) == 5


WINDOW = range(10000, 20001, 1000)
LIVE = [8.0, 30.0, 10.0, 12.0, 9.0, 40.0, 11.0, 10.0, 13.0, 9.0, 12.0]  # range 32, median 11


@pytest.mark.parametrize("case,ema,failed", [
    ("both_held", [14.0, 13.0, 15.0, 14.0, 14.0, 13.0, 15.0, 14.0, 14.0, 13.0, 14.0], set()),
    ("wider_than_live", [5.0, 50.0, 14.0, 14.0, 14.0, 13.0, 15.0, 14.0, 14.0, 13.0, 14.0],
     {"ema_steadiness"}),
    ("as_wide_as_live", [8.0, 40.0, 14.0, 14.0, 14.0, 13.0, 15.0, 14.0, 14.0, 13.0, 14.0],
     {"ema_steadiness"}),
    ("median_over_1_5x", [17.0, 16.0, 18.0, 17.0, 17.0, 16.0, 18.0, 17.0, 17.0, 16.0, 17.0],
     {"ema_level"}),
    ("median_at_1_5x", [16.5] * 11, set()),
])
def test_ema_rules_on_hand_made_curves(case, ema, failed):
    curves = {"gen": _curve([(i, f, 1.0) for i, f in zip(WINDOW, LIVE)], "gen"),
              "ema": _curve([(i, f, 1.0) for i, f in zip(WINDOW, ema)], "ema")}
    rules = tool.ema_rules(curves)
    judged = {k: rules[k]["pass"] for k in ("ema_steadiness", "ema_level")}
    assert {k for k, v in judged.items() if v is not True} == failed, case
    assert all(v is not None for v in judged.values())
    assert rules["ema_wins"]["snapshots"] == 11


def test_ema_rules_judge_a_cut_window_only_on_what_it_holds():
    """A run cut at 15,000 holds 6 of the window's 11 snapshots: `pass` stays
    None and `pass_on_present` judges the six; before 10,000 nothing is judged."""
    ema = [14.0, 13.0, 15.0, 14.0, 14.0, 13.0]
    curves = {"gen": _curve([(i, f, 1.0) for i, f in zip(WINDOW[:6], LIVE)], "gen"),
              "ema": _curve([(i, f, 1.0) for i, f in zip(WINDOW[:6], ema)], "ema")}
    rules = tool.ema_rules(curves)
    for name in ("ema_steadiness", "ema_level"):
        assert (rules[name]["snapshots"], rules[name]["of"]) == (6, 11)
        assert rules[name]["pass"] is None and rules[name]["pass_on_present"] is True
    early = {p: _curve([(1000, 5.0, 1.0), (2000, 3.0, 1.0)], p) for p in tool.PREFIXES}
    rules = tool.ema_rules(early)
    assert rules["ema_steadiness"]["pass_on_present"] is None
    assert rules["ema_level"]["value"] is None and rules["ema_wins"]["snapshots"] == 0


@pytest.mark.parametrize("start,end,want", [
    (0, 3000, {"1000": 6.01, "2000": 6.02, "3000": 6.03}),
    (1500, 3000, {"2000": 6.02, "3000": 6.03}),
])
def test_rss_profile_per_1000_and_slope(start, end, want):
    """VmRSS at each 1,000 and the least-squares slope from 500 iterations
    into the segment, on samples rising 1e-5 GiB an iteration."""
    gib = 2**30
    rss = [(0.0, start, 4 * gib)] + [(float(it), it, int((6 + it * 1e-5) * gib))
                                     for it in range(start + 100, end + 1, 100)]
    prof = tool.rss_profile(rss, start, end)
    assert prof["rss_gib_per_1000"] == want
    assert prof["rss_slope_gib_per_1000_after_500"] == pytest.approx(0.01, abs=1e-5)


def test_ema_distance_is_zero_at_init_and_grows_with_a_step():
    """The EMA generators' rel-L2 from the live ones: 0 while the EMA is a
    copy of the weights, about (1 - d) of the step's relative size after one
    G step, per generator."""
    import numpy as np
    import torch

    from aclgan_tpu_torch.config import from_dict
    from aclgan_tpu_torch.trainer import ACLGAN

    cfg = from_dict({"batch_size": 2, "new_size": 16, "crop_image_height": 16,
                     "crop_image_width": 16, "synthetic": True,
                     "gen": {"dim": 8, "mlp_dim": 16, "n_res": 1},
                     "dis": {"dim": 8, "n_layer": 2, "num_scales": 1},
                     "tpu": {"compute_dtype": "float32", "ema_decay": 0.9}})
    model = ACLGAN(cfg, device="cpu")
    model.init_state()
    assert tool.ema_distance(model) == {"AB": 0.0, "BA": 0.0}
    x = np.random.RandomState(0).randint(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    model.train_step(x, x, True, True)
    got = tool.ema_distance(model)
    assert set(got) == {"AB", "BA"} and all(0.0 < v < 0.1 for v in got.values()), got
    assert not any(t.requires_grad for t in model.ema["AB"].values())
    assert torch.is_grad_enabled()


def _data(root, n=2000):
    for d in ("trainA", "trainB"):
        (root / d).mkdir(parents=True)
        for i in range(n):
            (root / d / f"{i:05d}.jpg").write_bytes(b"")


def test_train_stage_stops_after_a_snapshot_at_its_deadline(tmp_path, monkeypatch):
    """A CLI that logs every 100 iterations at 20 s a line and snapshots every
    1,000, under a deadline 300 s after the start: the next snapshot fits at
    the line of 100 (0.2 s an iteration, 900 iterations and 30 s to go), not
    at 1,100, so the stage stops the CLI there and counts the cadence to 1,100."""
    from aclgan_tpu_torch.cli import train

    clock = {"now": 1000.0}

    def fake_main(argv):
        ckpt = Path(argv[argv.index("--output_path") + 1]) / "outputs" / "synthfaces_hard"
        for it in range(100, 3001, 100):
            clock["now"] += 20.0
            print(f"Iteration: {it:08d}/00003000 (20.0000s)")
            if it % 1000 == 0:
                _snapshots(ckpt / "checkpoints", [it])

    monkeypatch.setattr(tool.time, "time", lambda: clock["now"])
    monkeypatch.setattr(train, "main", fake_main)
    w = tmp_path / "w"
    _data(w / "data")
    seg = tool.main(["train", "--work", str(w), "--device", "cpu", "--iters", "3000",
                     "--deadline", "300"])["train"]
    cfg = load_config(w / "synthfaces_hard.yaml")
    assert (seg["start"], seg["end"], seg["stopped_at"]) == (0, 1100, 1100)
    assert [it for it, _ in seg["iteration_lines"]][-1] == 1100
    assert seg["derived"] == tool.cadence_counts(0, 1100, 125, cfg)
    assert tool.train_plan(w / "run" / "outputs" / "synthfaces_hard" / "checkpoints",
                           3000) == 1000


@pytest.mark.parametrize("score_on", [None, "2,3"], ids=["one_follow", "a_follow_a_card"])
def test_all_alongside_scores_beside_training(tmp_path, monkeypatch, score_on):
    """`all --alongside`: the dataset, then `follow` in a second process (here
    a thread) with its BLAS threads capped while `train` runs, then `report`
    on both curves. With `--score_on 2,3` one `follow` a family, each seeing
    only its card: the first trains the classifier and calibrates, the other
    waits for the classifier. What was left to score when training ended
    goes to alongside.json."""
    import threading

    fake = _FakeEntryPoints(monkeypatch)
    docs = tmp_path / "docs"
    monkeypatch.setattr(tool, "DOCS", docs)
    monkeypatch.setattr(tool, "FOLLOW_POLL", 0.01)
    children = []

    class _Child:
        def __init__(self, cmd, cwd, env, stdout, stderr):
            children.append((cmd, env))
            self.thread = threading.Thread(target=tool.main, args=(cmd[2:],))
            self.thread.start()

        def wait(self):
            self.thread.join()
            return 0

    monkeypatch.setattr(tool.subprocess, "Popen", _Child)
    w = tmp_path / "w"
    out = tool.main(["all", "--alongside", "--work", str(w), "--device", "cpu",
                     "--iters", "3000"] + (["--score_on", score_on] if score_on else []))
    base = ["follow", "--work", str(w), "--device", "cpu", "--data_root", str(w / "data")]
    if score_on is None:
        (cmd, env), = children
        assert cmd[2:] == base and "CUDA_VISIBLE_DEVICES" not in env
    else:
        assert [(c[2:], e["CUDA_VISIBLE_DEVICES"]) for c, e in children] == [
            (base + ["--families", "gen"], "2"), (base + ["--families", "ema"], "3")]
    for _, env in children:
        assert env["OPENBLAS_NUM_THREADS"] == env["OMP_NUM_THREADS"] == str(tool.SCORER_THREADS)
    kinds = [c[0] for c in fake.calls]
    assert kinds[0] == "dataset" and kinds[-1] == "grid" and kinds.count("fid_curve") >= 2
    assert kinds.count("inception") == kinds.count("calibrate") == 1
    assert sorted(set(kinds)) == ["calibrate", "dataset", "fid_curve", "grid", "inception",
                                  "train"]
    assert (w / "train.done").exists()
    alongside = json.loads(tool.Work.at(w).log("alongside").read_text())
    assert set(alongside["unscored_at_train_end"]) == set(tool.PREFIXES)
    assert out["report"]["alongside"] == alongside
    assert out["report"]["curves"]["gen"]["iterations"] == [1000, 2000, 3000]
    assert out["report"]["bars"]["ema_steadiness"]["snapshots"] == 0
    assert sorted(p.name for p in docs.iterdir()) == [
        "fid_curve_ema.json", "fid_curve_gen.json", "summary.json"]


def _snapshots(ckpt, stamps, families=("gen", "dis", "ema"), optimizer=True):
    """Stand-ins for snapshot files (a byte each: `report` takes a zero-byte
    file for one a cut call listed but did not bring back)."""
    ckpt.mkdir(parents=True, exist_ok=True)
    for s in stamps:
        for f in families:
            (ckpt / f"{f}_{s:08d}.pt").write_bytes(b"\0")
    if optimizer:
        (ckpt / "optimizer.pt").write_bytes(b"")


@pytest.mark.parametrize("case,stamps,extra,iters,want", [
    ("fresh", [], None, 3000, 0),
    ("resume_newest", [1000, 2000], None, 3000, 2000),
    ("done", [1000, 2000, 3000], None, 3000, None),
    ("done_past", [1000, 2000, 3000], None, 2500, None),
    ("alias_and_tmp_ignored", [1000], "gen_latest.pt", 3000, 1000),
])
def test_train_plan_from_snapshot_files(tmp_path, case, stamps, extra, iters, want):
    ckpt = tmp_path / "checkpoints"
    _snapshots(ckpt, stamps, optimizer=bool(stamps))
    if extra:
        (ckpt / extra).write_bytes(b"")
        (ckpt / "gen_00009000.pt.tmp.12").write_bytes(b"")
    assert tool.train_plan(ckpt, iters) == want, case


@pytest.mark.parametrize("case", ["no_ema", "no_optimizer"])
def test_train_plan_refuses_a_torn_set(tmp_path, case):
    ckpt = tmp_path / "checkpoints"
    _snapshots(ckpt, [1000])
    if case == "no_ema":
        _snapshots(ckpt, [2000], families=("gen", "dis"))
        match = "gen_00002000.pt"
    else:
        (ckpt / "optimizer.pt").unlink()
        match = "gen_00001000.pt"
    with pytest.raises(RuntimeError, match=match):
        tool.train_plan(ckpt, 3000)


def _curve_doc(sizes, prefix, its):
    return {**tool.curve_meta(sizes, prefix),
            "rows": [{"iteration": i, "fid": 1.0} for i in its]}


@pytest.mark.parametrize("case,its,stamps,want", [
    ("fresh", None, [1000, 2000], 0),
    ("continue", [1000, 2000], [1000, 2000, 3000], 2000),
    ("complete", [1000, 2000, 3000], [1000, 2000, 3000], None),
])
def test_curve_plan(case, its, stamps, want):
    doc = None if its is None else _curve_doc(tool.FULL, "ema", its)
    assert tool.curve_plan(doc, stamps, tool.curve_meta(tool.FULL, "ema")) == want, case


def test_curve_plan_refuses_a_file_of_another_protocol():
    doc = _curve_doc(tool.SMOKE, "gen", [20])
    with pytest.raises(ValueError, match="another protocol"):
        tool.curve_plan(doc, [20, 40], tool.curve_meta(tool.FULL, "gen"))


@pytest.mark.parametrize("case,start,end,epoch,sizes,want", [
    # 64 images a domain at batch 16: 4 batches an epoch, one grid set at 40
    ("smoke", 0, 40, 4, tool.SMOKE, dict(dg=20, d_only=20, g_steps=20, samples=3,
                                         k1=98 * 20 + 49 * 20 + 57 * 3, k2=49 * 20)),
    # 2000 at batch 16: 125 batches, an odd epoch runs G on its last and the
    # next epoch's first iteration; grids at 2000
    ("full", 0, 3000, 125, tool.FULL, dict(dg=24 * 63, d_only=24 * 62, g_steps=24 * 63,
                                           samples=3, k1=98 * 1512 + 49 * 1488 + 57 * 3,
                                           k2=49 * 1512)),
    # a resumed call restarts the epoch-local cadence at its first iteration
    ("resumed", 1000, 1250, 125, tool.FULL, dict(dg=126, d_only=124, g_steps=126,
                                                 samples=0, k1=98 * 126 + 49 * 124,
                                                 k2=49 * 126)),
])
def test_cadence_counts(case, start, end, epoch, sizes, want):
    cfg = tool.derived_config("/data", sizes)
    assert tool.cadence_counts(start, end, epoch, cfg) == want, case


@pytest.mark.parametrize("key,value", [
    ("batch_size", 8), ("max_iter", 3000), ("gen.dim", 32), ("tpu.ema_decay", 0.0),
    ("tpu.compute_dtype", "float32"), ("snapshot_save_iter", 20),
])
def test_config_guard_refuses_a_changed_key(key, value):
    cfg = tool.derived_config("/data", tool.FULL)
    *outer, leaf = key.split(".")
    target = getattr(cfg, outer[0]) if outer else cfg
    setattr(target, leaf, value)
    with pytest.raises(ValueError, match=key):
        tool.check_config(cfg, tool.FULL)


def test_config_guard_takes_data_root_and_the_smoke_sizes(tmp_path):
    cfg = tool.derived_config(tmp_path / "ds", tool.SMOKE)
    tool.check_config(cfg, tool.SMOKE)
    assert cfg.snapshot_save_iter == 20 and cfg.data.data_root == str(tmp_path / "ds")
    with pytest.raises(ValueError, match="snapshot_save_iter"):
        tool.check_config(cfg, tool.FULL)
    work = tool.Work.at(tmp_path / "w", data_root=tmp_path / "ds")
    written = tool.ensure_config(work, tool.SMOKE)
    assert work.config.name == "synthfaces_hard.yaml"
    assert written.to_dict() == cfg.to_dict()
    edited = load_config(work.config)
    edited.lr = 2e-4
    save_config(edited, work.config)
    with pytest.raises(ValueError, match="lr"):
        tool.ensure_config(work, tool.SMOKE)


@pytest.mark.parametrize("key,value", [("n", 64), ("styles", 2), ("bootstrap", 20),
                                       ("protocol", "one style, train blend")])
def test_report_refuses_curves_of_another_protocol(tmp_path, key, value):
    docs = {p: dict(_recorded(p), **{key: value}) for p in tool.PREFIXES}
    work = _work_with_curves(tmp_path, docs)
    # the port's two families agree with each other, not with the recorded run
    with pytest.raises(tool.Refused, match=f"jax against torch: protocol mismatch on '{key}'"):
        tool.report(work, tool.FULL, RECORDED, docs=None)
    assert tool.report(work, tool.FULL, None, docs=None)["against_recorded"] == {}
    with pytest.raises(SystemExit, match="refused"):
        tool.main(["report", "--work", str(work.root), "--device", "cpu"])


class _FakeEntryPoints:
    """Stands in for make_dataset and the CLIs' `main`: records each argv and
    leaves the files the next stage reads."""

    def __init__(self, monkeypatch):
        from aclgan_tpu_torch.cli import fid_curve, train, train_inception

        self.calls = []
        monkeypatch.setattr(tool, "run_dataset", self.dataset)
        monkeypatch.setattr(train, "main", self.train)
        monkeypatch.setattr(train_inception, "main", self.inception)
        monkeypatch.setattr(fid_curve, "main", self.fid_curve)
        monkeypatch.setattr(tool, "calibration_fids", self.calibrate)
        monkeypatch.setattr(tool, "snapshot_grid", self.grid)

    def _arg(self, argv, flag, default=None):
        return argv[argv.index(flag) + 1] if flag in argv else default

    def dataset(self, argv):
        self.calls.append(("dataset", argv))
        out = Path(self._arg(argv, "--out"))
        for d, n in (("trainA", "--n"), ("trainB", "--n"), ("testA", "--n_test"),
                     ("testB", "--n_test")):
            (out / d).mkdir(parents=True)
            for i in range(int(self._arg(argv, n))):
                (out / d / f"{i:05d}.jpg").write_bytes(b"")

    def train(self, argv):
        self.calls.append(("train", argv))
        print("Iteration: 00000100/00003000 (25.0000s)")
        out = Path(self._arg(argv, "--output_path"))
        ckpt = out / "outputs" / "synthfaces_hard" / "checkpoints"
        _snapshots(ckpt, range(1000, int(self._arg(argv, "--max_iter")) + 1, 1000))
        logs = out / "logs" / "synthfaces_hard"
        logs.mkdir(parents=True, exist_ok=True)
        with open(logs / "scalars.jsonl", "a") as f:
            f.write(json.dumps({"step": 100, "loss_dis_total": 1.0}) + "\n")

    def inception(self, argv):
        self.calls.append(("inception", argv))
        Path(self._arg(argv, "--out")).write_bytes(b"")
        return {"loss": 0.01, "accuracy": 1.0, "train_seconds": 1.0,
                "steps_per_second": 300.0, "weights_sha256": "ab" * 32}

    def fid_curve(self, argv):
        self.calls.append(("fid_curve", argv))
        prefix = self._arg(argv, "--prefix")
        run_dir = Path(self._arg(argv, "--run_dir"))
        after = int(self._arg(argv, "--start_after", 0))
        stamps = tool.snapshot_stamps(run_dir / "checkpoints", prefix)
        rec = {r["iteration"]: r for r in _recorded(prefix)["rows"]}
        path = run_dir / f"fid_curve_{prefix}.json"
        rows = json.loads(path.read_text())["rows"] if after else []
        rows += [rec[s] for s in stamps if s > after]
        path.write_text(json.dumps({**_recorded(prefix), "rows": rows, "complete": True}))
        return {"path": str(path), "rows": rows, "seconds": [], "fid_seconds": []}

    def calibrate(self, cfg, inception, data_root, n, device):
        self.calls.append(("calibrate", [str(inception), str(data_root), n, device]))
        return {"n": n, "domain_gap": 40.0, "floor": 1.0}

    def grid(self, cfg, snap, out, device):
        self.calls.append(("grid", [Path(snap).name, out.name]))
        return out


def test_all_plan_calls_the_entry_points_with_their_argv(tmp_path, monkeypatch):
    """`all` at 3000 iterations, then again at 4000: the second call resumes
    training and both sweeps, and skips the dataset, the classifier and the
    calibration."""
    fake = _FakeEntryPoints(monkeypatch)
    w = tmp_path / "w"
    docs = tmp_path / "docs"
    monkeypatch.setattr(tool, "DOCS", docs)
    base = ["--work", str(w), "--device", "cpu"]
    cfg, run = str(w / "synthfaces_hard.yaml"), str(w / "run" / "outputs" / "synthfaces_hard")

    def curve(prefix, *extra):
        return ("fid_curve", ["--config", cfg, "--run_dir", run, "--inception_weights",
                              str(w / "inception.pt"), "--n", "500", "--styles", "3",
                              "--bootstrap", "100", "--prefix", prefix, "--device", "cpu",
                              *extra])

    out = tool.main(["all", *base, "--iters", "3000"])
    assert fake.calls == [
        ("dataset", ["--out", str(w / "data"), "--style", "hard", "--n", "2000",
                     "--n_test", "500", "--size", "286"]),
        ("train", ["--config", cfg, "--output_path", str(w / "run"), "--max_iter", "3000",
                   "--device", "cpu"]),
        ("inception", ["--data_root", str(w / "data"), "--out", str(w / "inception.pt"),
                       "--steps", "300", "--batch", "32", "--size", "149", "--seed", "0",
                       "--device", "cpu"]),
        curve("gen"), curve("ema"),
        ("calibrate", [str(w / "inception.pt"), str(w / "data"), 500, "cpu"]),
        ("grid", ["ema_00003000.pt", "ema_a2b_test_hard_00003000_small.jpg"]),
    ]
    assert load_config(cfg).data.data_root == str(w / "data")
    assert json.loads((w / "inception.json").read_text())["weights_sha256"] == "ab" * 32
    seg = out["train"]
    assert [tuple(x) for x in seg["iteration_lines"]] == [(100, 25.0)]
    assert seg["derived"]["k1"] == 98 * 1512 + 49 * 1488 + 57 * 3
    assert out["report"]["train"]["nonfinite_logged"] == 0
    assert out["report"]["train"]["snapshots_missing"] == {"gen": [], "ema": []}
    assert sorted(p.name for p in docs.iterdir()) == [
        "fid_curve_ema.json", "fid_curve_gen.json", "summary.json"]

    fake.calls.clear()
    tool.main(["all", *base, "--iters", "4000"])
    assert [c[0] for c in fake.calls] == ["train", "fid_curve", "fid_curve", "grid"]
    assert fake.calls[0][1][-1] == "--resume" and "4000" in fake.calls[0][1]
    assert fake.calls[1] == curve("gen", "--start_after", "3000")
    assert fake.calls[2] == curve("ema", "--start_after", "3000")
    summary = json.loads((docs / "summary.json").read_text())
    assert [s["iterations"] for s in summary["train"]["segments"]] == [[0, 3000], [3000, 4000]]
    assert summary["curves"]["gen"]["iterations"] == [1000, 2000, 3000, 4000]


class _MeanScorer:
    """Stands in for the classifier: each image's channel means and the
    square sizes of the batches it was given."""

    sizes = []

    def __init__(self, weights, device):
        pass

    def features(self, images01):
        self.sizes.append(images01.shape[1:3])
        return images01.mean((1, 2)).astype("float64")

    def predict(self, images01):
        """B (class 1) for a dark image, A for a light one."""
        dark = (images01.mean((1, 2, 3)) < 0.45).astype("float64")
        return __import__("numpy").stack([1.0 - dark, dark], -1)


def test_calibration_loads_each_side_as_the_curve_loads_its_real_side(tmp_path, monkeypatch):
    """FID(testA, testB) and FID(trainB[:n], testB) through
    `cli.fid_curve`'s loading: the source domain's size (a -> b), the first
    n images in order. trainB starts with testB's images, so the floor is 0.
    The share of real testB (dark) and of real testA (light) rated as B."""
    import dataclasses

    import numpy as np
    from PIL import Image

    from aclgan_tpu_torch.eval import inception

    rng = np.random.RandomState(0)
    data = tmp_path / "data"
    for d in ("testA", "testB", "trainB"):
        (data / d).mkdir(parents=True)
    for i in range(8):
        a = rng.randint(0, 136, (20, 20, 3), dtype=np.uint8)
        Image.fromarray(a + 120).save(data / "testA" / f"{i:03d}.png")
        Image.fromarray(a).save(data / "testB" / f"{i:03d}.png")
        Image.fromarray(a).save(data / "trainB" / f"{i:03d}.png")
        Image.fromarray(255 - a).save(data / "trainB" / f"{i + 8:03d}.png")
    cfg = tool.derived_config(data, tool.FULL)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, new_size=None,
                                                            new_size_a=24, new_size_b=16))
    monkeypatch.setattr(inception, "InceptionScorer", _MeanScorer)
    _MeanScorer.sizes = []
    out = tool.calibration_fids(cfg, tmp_path / "inception.pt", data, 8, "cpu")
    assert set(_MeanScorer.sizes) == {(24, 24)}
    # testA is testB shifted by 120/255 in each channel: a gap of about 3 * 0.47^2
    assert out["n"] == 8 and out["domain_gap"] > 0.5 and abs(out["floor"]) < 1e-3
    assert out["real_as_b"] == {"testB": 1.0, "testA": 0.0}


def test_pillow_and_libjpeg_routes_agree_on_hard_images(tmp_path):
    """The loader's two JPEG routes on `make_dataset.py --style hard` images
    at the config's transform: the JAX run decoded through the libjpeg core,
    the card's host (no libjpeg headers) decodes through Pillow. They differ
    by at most one level of 255 and by a tenth of a level on average."""
    import os
    import shutil

    import numpy as np

    from aclgan_tpu_torch.data import loader, native
    from aclgan_tpu_torch.data.dataset import list_images_folder
    from aclgan_tpu_torch.data.transforms import TransformSpec

    if shutil.which("g++") is None or not os.path.exists("/usr/include/jpeglib.h"):
        pytest.skip("g++ or libjpeg's headers are missing: the core cannot be built")
    assert native.available(), "the port's core did not build"
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_dataset.py"), "--out",
                    str(tmp_path), "--style", "hard", "--n", "8", "--n_test", "8",
                    "--size", "286"], check=True, capture_output=True, timeout=120)
    d = load_config(tool.SHIPPED).data
    spec = TransformSpec(d.new_size, d.crop_image_height, d.crop_image_width, True)
    paths = list_images_folder(str(tmp_path / "trainA")) + list_images_folder(
        str(tmp_path / "testB"))
    core, pillow = (loader.ImageDataset(paths, spec, use_native=on) for on in (True, False))
    assert core.native and not pillow.native
    diff = np.stack([np.abs(core.get(i, np.random.default_rng(i)).astype(np.int16)
                            - pillow.get(i, np.random.default_rng(i)))
                     for i in range(len(paths))])
    assert diff.shape == (16, d.crop_image_height, d.crop_image_width, 3)
    assert diff.max() <= 1 and diff.mean() < 0.15, (diff.max(), diff.mean())


def test_entry_point_raises_without_a_card(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["train", "--work", str(tmp_path)])


def test_tool_import_loads_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tools')!r}); "
            "import torch_synthfaces_hard as t; t._fid_compare(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'aclgan_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


# ------------------------------------------------------------------ --world 2
WORLD = 2


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    """The train stage with `--world 2 --device cpu` (two gloo ranks under the
    torchrun launcher) on a tiny config in the work directory: batch 4 (2 a
    rank) on 8 PNGs a domain, a line every 3 iterations, a snapshot and a
    train grid every 2, EMA 0.9, to 6 iterations under a 1 s deadline. The
    first line after a snapshot with a decision is 3 (at 1 rank 0 has none
    yet), so every rank stops at 3, after the snapshot at 2."""
    import numpy as np
    from PIL import Image

    from aclgan_tpu_torch import config
    from tests.helpers import tiny_config

    w = tmp_path_factory.mktemp("world") / "w"
    rng = np.random.RandomState(0)
    for sub in ("trainA", "trainB", "testA", "testB"):
        (w / "data" / sub).mkdir(parents=True)
        for i in range(8):
            Image.fromarray(rng.randint(0, 256, (22, 24, 3), dtype=np.uint8)).save(
                w / "data" / sub / f"{i}.png")
    cfg = config.from_dict(tiny_config(batch_size=4, display_size=2, image_save_iter=4,
                                       image_display_iter=2, snapshot_save_iter=2,
                                       log_iter=3, seed=11).to_dict())
    cfg.data.synthetic, cfg.data.data_root, cfg.data.num_workers = False, str(w / "data"), 0
    cfg.data.new_size, cfg.data.crop_image_height, cfg.data.crop_image_width = 20, 16, 16
    cfg.tpu.ema_decay = 0.9
    config.save_config(cfg, w / "synthfaces_hard.yaml")
    mp = pytest.MonkeyPatch()
    # the guard holds a run to the shipped config; this one is cut to the CPU
    mp.setattr(tool, "ensure_config", lambda work, sizes: config.load_config(work.config))
    try:
        seg = tool.main(["train", "--work", str(w), "--data_root", str(w / "data"),
                         "--device", "cpu", "--world", str(WORLD), "--iters", "6",
                         "--deadline", "1"])["train"]
    finally:
        mp.undo()
    return w, cfg, seg


def test_world_2_train_stage_records_each_rank(world_run):
    """One segment entry a rank: each rank's D+G / D-only steps and display
    samples equal `cadence_counts` for its rank (rank 0 alone samples), the
    EMA's distance on rank 0 alone, VmRSS and the feed's waits on both; the
    segment's top level is rank 0's, as a single process's."""
    w, cfg, seg = world_run
    epoch_len = 8 // (cfg.batch_size // WORLD)
    assert (seg["world"], seg["epoch_len"], len(seg["ranks"])) == (WORLD, epoch_len, WORLD)
    for rank, r in enumerate(seg["ranks"]):
        want = tool.cadence_counts(0, 3, epoch_len, cfg, rank)
        assert r["rank"] == rank and r["derived"] == want
        assert (r["steps"]["dg"], r["steps"]["d_only"], r["steps"]["samples"]) == (
            want["dg"], want["d_only"], want["samples"])
        assert r["rss"] and [it for it, _ in r["feed_wait_seconds"]] == [3]
        assert bool(r["ema_from_live_rel_l2"]) == (rank == 0)
    assert seg["ranks"][0]["steps"]["samples"] == 1 and seg["ranks"][1]["steps"]["samples"] == 0
    assert set(seg["ema_from_live_rel_l2"]) == {"2"}
    assert [it for it, _ in seg["iteration_lines"]] == [3]
    assert seg["derived"] == seg["ranks"][0]["derived"]
    summary = tool.train_summary(tool._read(w / "train_log.json"), w / "none.jsonl",
                                 {p: [2] for p in tool.PREFIXES}, cfg.snapshot_save_iter)
    ranks = summary["segments"][0]["ranks"]
    assert [r["steps_ok"] for r in ranks] == [True, True]
    assert [r["launches_ok"] for r in ranks] == [None, None]  # no kernel on the CPU


def test_world_2_deadline_stops_every_rank_at_one_iteration(world_run):
    """Under `--deadline`, rank 0's decision at the line after a snapshot
    reaches every rank through one broadcast: both end at iteration 3, the
    launcher exits cleanly (no rank dumped its stack), and the run resumes
    from the snapshot at 2."""
    w, cfg, seg = world_run
    assert (seg["start"], seg["end"], seg["stopped_at"]) == (0, 3, 3)
    assert [(r["end"], r["stopped_at"]) for r in seg["ranks"]] == [(3, 3)] * WORLD
    assert not any(p.stat().st_size for p in (w / "dumps").glob("stack.*.txt"))
    assert tool.train_plan(w / "run" / "outputs" / "synthfaces_hard" / "checkpoints", 6) == 2


def test_classifier_gate_on_hand_made_rates():
    """The gate of `BARS`: real testB rated B at >= 0.99 and real testA at
    <= 0.01; without calibration's rates it is not judged."""
    assert tool.classifier_gate({"real_as_b": {"testB": 0.99, "testA": 0.01}})["pass"] is True
    assert tool.classifier_gate({"real_as_b": {"testB": 0.988, "testA": 0.0}})["pass"] is False
    assert tool.classifier_gate({"real_as_b": {"testB": 1.0, "testA": 0.012}})["pass"] is False
    assert tool.classifier_gate({"domain_gap": 40.0})["pass"] is None
    assert tool.classifier_gate(None)["pass"] is None


WINDOW_OPEN = "not judged: ema_steadiness, ema_level"  # no snapshot from 10,000 on


@pytest.mark.parametrize("rates,verdict", [
    ({"testB": 1.0, "testA": 0.0}, WINDOW_OPEN),
    ({"testB": 0.9, "testA": 0.0}, tool.GATE_FAILED),
    (None, "not judged: classifier_gate, ema_steadiness, ema_level"),
])
def test_report_reads_no_bar_behind_a_failed_gate(tmp_path, rates, verdict):
    """`report` on curves that hold every bar they reach (1,000-3,000: the
    EMA's window is not judged): under a classifier that passed its gate the
    verdict names only that window; under one that failed it, no bar is read
    (each `pass` None, `not_read` says why) and the verdict says so; without
    the rates the gate is not judged."""
    curves = {p: _curve(GOOD[p], p) for p in tool.PREFIXES}
    work = _work_with_curves(tmp_path, curves)
    calib = {"n": 500, "domain_gap": 40.0, "floor": 1.5}
    if rates is not None:
        calib["real_as_b"] = rates
    work.log("calibrate").write_text(json.dumps(calib))
    work.log("inception").write_text(json.dumps({"accuracy": 1.0}))
    s = tool.report(work, tool.FULL, None, docs=None)
    assert s["verdict"] == verdict
    assert s["bars"]["classifier_gate"]["value"] == rates
    quality = {k: b for k, b in s["bars"].items() if k != "classifier_gate"}
    if verdict == tool.GATE_FAILED:
        assert all(b["pass"] is None and b["not_read"] == tool.GATE_FAILED
                   for b in quality.values())
    else:
        held = {k for k, b in quality.items() if b["pass"] is True}
        assert held == {"classifier_accuracy", "target_domain_rate", "ema_warmup",
                        "best_over_domain_gap"}


def _printed(it, fid, rate, ci):
    """A row as `cli.fid_curve` prints it (3 styles, bootstrap)."""
    return (f"iter {it:>8}: FID {fid:.3f}  target-domain rate {rate:.4f}  styles [1.0, 2.0, "
            f"3.0] spread 2.0  ci95 {ci} (80.1 s)")


def test_recover_rebuilds_the_curves_of_a_cut_call_from_its_follow_logs(tmp_path,
                                                                         monkeypatch):
    """`recover` on a work directory whose curve files a cut call never
    copied out: a one-family `follow_<family>.log` gives its rows, those of a
    sweep cut before its `wrote` line included; in a two-family `follow.log`
    each row goes to the family its sweep wrote, and a reprinted iteration
    keeps its last print. The files carry the run's protocol, so `report`
    reads them; the zero-byte files that stand for snapshots the call did
    not bring back count as snapshots and get no grid."""
    work = tool.Work.at(tmp_path / "w")
    work.root.mkdir(parents=True)
    tool.ensure_config(work, tool.FULL)
    run = str(work.run_dir)
    (work.root / "follow_ema.log").write_text("\n".join([
        "[synthfaces_hard] stage follow", _printed(1000, 30.0, 0.71, [25.0, 35.0]),
        "| 1000 | 30.0 | 0.71 | 2.0 | [25.0, 35.0] |", f"wrote {run}/fid_curve_ema.json",
        "merged 1 prior rows", _printed(2000, 8.0, 0.995, [6.0, 9.0])]) + "\n")
    (work.root / "follow.log").write_text("\n".join([
        _printed(1000, 5.0, 1.0, [4.0, 6.0]), _printed(2000, 3.5, 1.0, [3.0, 4.0]),
        _printed(2000, 3.0, 1.0, [2.5, 3.5]), f"wrote {run}/fid_curve_gen.json",
        _printed(3000, 9.0, 1.0, [8.0, 10.0])]) + "\n")
    got = tool.curve_rows_from_log((work.root / "follow.log").read_text())
    assert sorted(got["gen"]) == [1000, 2000] and got["ema"] == {}
    assert got["gen"][2000] == {"iteration": 2000, "fid": 3.0, "target_domain_rate": 1.0,
                                "fid_styles": [1.0, 2.0, 3.0], "fid_spread": 2.0,
                                "fid_ci95": [2.5, 3.5]}
    out = tool.main(["recover", "--work", str(work.root), "--device", "cpu"])["recover"]
    assert out == {"gen": {"rows": 2, "last": 2000}, "ema": {"rows": 2, "last": 2000}}
    for p in tool.PREFIXES:
        doc = json.loads(work.curve(p).read_text())
        assert {k: doc[k] for k in tool.curve_meta(tool.FULL, p)} == tool.curve_meta(tool.FULL, p)
        assert doc["complete"] is False and [r["iteration"] for r in doc["rows"]] == [1000, 2000]
    assert tool.main(["recover", "--work", str(work.root), "--device", "cpu"])["recover"] == {
        p: {"skipped": True} for p in tool.PREFIXES}
    for p in ("gen", "dis", "ema"):
        for it in (1000, 2000):
            (work.checkpoints / f"{p}_{it:08d}.pt").parent.mkdir(parents=True, exist_ok=True)
            (work.checkpoints / f"{p}_{it:08d}.pt").write_bytes(b"")
    monkeypatch.setattr(tool, "snapshot_grid", None)  # not to be called
    s = tool.report(work, tool.FULL, RECORDED, docs=tmp_path / "docs")
    assert s["curves"]["ema"]["iterations"] == [1000, 2000]
    assert s["bars"]["ema_warmup"]["value"] == {"ema": 30.0, "gen": 5.0}
    assert s["selected"] == {"prefix": "gen", "iteration": 2000, "fid": 3.0}
    assert s["train"] is None and (tmp_path / "docs" / "summary.json").exists()


# ------------------------------------------------------------------ --score_after
def test_process_cpu_seconds_counts_this_process_threads_too():
    """A thread's CPU time is the process's: the loader's workers are threads."""
    import threading

    def spin(until):
        while time.thread_time() < until:
            pass

    t0 = tool.process_cpu_seconds()
    worker = threading.Thread(target=spin, args=(time.thread_time() + 0.2,))
    worker.start()
    worker.join()
    assert tool.process_cpu_seconds() - t0 >= 0.15


def test_world_2_ranks_record_their_cpu_seconds(world_run, capsys):
    """Each rank reads its process's CPU seconds at its start and at each
    line; `_rank_summary` puts them a second of each window beside the
    feed's wait share, and `report` prints both."""
    w, cfg, seg = world_run
    for r in seg["ranks"]:
        cpu = r["cpu_seconds"]
        assert [it for it, _ in cpu] == [0, 3] and 0 <= cpu[0][1] < cpu[1][1]
    summary = tool.train_summary(tool._read(w / "train_log.json"), w / "none.jsonl",
                                 {p: [2] for p in tool.PREFIXES}, cfg.snapshot_save_iter)
    for r in summary["segments"][0]["ranks"]:
        assert set(r["cpu_seconds_a_second"]) == set(r["feed_wait_share"]) == {"1-3"}
        assert r["cpu_seconds_a_second"]["1-3"] > 0.0
    curves = {p: _curve(GOOD[p], p) for p in tool.PREFIXES}
    tool._print_report({"calibrate": None, "curves": {p: tool.curve_summary(c)
                                                      for p, c in curves.items()},
                        "train": summary, "verdict": "v", "bars": {}}, curves, {})
    out = capsys.readouterr().out
    assert out.count("feed-wait share / CPU seconds a second of each 1,000") == WORLD


@pytest.mark.parametrize("n", [1, 2, 3])
def test_score_split_takes_each_family_snapshot_once_interleaved(n):
    """The family-snapshots in iteration order, gen before ema; the k-th
    scorer takes every n-th from the k-th on."""
    stamps = {"gen": [1000, 2000, 3000, 4000, 5000], "ema": [1000, 2000, 3000, 4000]}
    order = [(p, it) for it in range(1000, 5001, 1000) for p in tool.PREFIXES
             if it in stamps[p]]
    shares = tool.score_split(stamps, n)
    assert len(shares) == n
    assert sorted(x for s in shares for x in s) == sorted(order)
    for k, share in enumerate(shares):
        assert share == order[k::n]
    if n == 2:  # an even split gives each scorer one family
        assert {p for p, _ in shares[0]} == {"gen"} and {p for p, _ in shares[1]} == {"ema"}


def _part(work, k, prefix, its, sizes=None, **change):
    path = work.scorer_dir(k) / f"fid_curve_{prefix}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = [{"iteration": i, "fid": float(i) / 1000, "target_domain_rate": 1.0} for i in its]
    path.write_text(json.dumps({**tool.curve_meta(sizes or tool.FULL, prefix), "rows": rows,
                                "best": rows[0], "complete": True, **change}))
    return path


def test_merge_refuses_a_part_of_another_protocol(tmp_path):
    work = tool.Work.at(tmp_path / "w")
    work.run_dir.mkdir(parents=True)
    _part(work, 0, "gen", [1000])
    bad = _part(work, 1, "gen", [2000], n=64)
    with pytest.raises(ValueError, match=f"{bad}.*another protocol"):
        tool.merge_parts(work, tool.FULL)
    assert not work.curve("gen").exists()
    _part(work, 1, "gen", [2000], sizes=tool.SMOKE)
    with pytest.raises(ValueError, match="another protocol"):
        tool.merge_parts(work, tool.FULL)


def test_recover_merges_the_part_files_of_a_cut_call(tmp_path):
    """A call cut while scoring left part files under DIR/score and no
    merged curve (gen) or an older one (ema): `recover` adds every part's
    rows, sorted, and a second `recover` finds nothing to add."""
    work = tool.Work.at(tmp_path / "w")
    work.root.mkdir(parents=True)
    tool.ensure_config(work, tool.FULL)
    _snapshots(work.checkpoints, [1000, 2000, 3000])
    _part(work, 0, "gen", [1000, 3000])
    _part(work, 1, "gen", [2000])
    _part(work, 1, "ema", [2000])
    work.curve("ema").write_text(json.dumps(
        {**tool.curve_meta(tool.FULL, "ema"), "complete": False,
         "rows": [{"iteration": 1000, "fid": 9.0, "target_domain_rate": 1.0}]}))
    out = tool.main(["recover", "--work", str(work.root), "--device", "cpu"])["recover"]
    assert out == {"gen": {"rows": 3, "last": 3000, "from_parts": 3},
                   "ema": {"rows": 2, "last": 2000, "from_parts": 1}}
    gen, ema = (json.loads(work.curve(p).read_text()) for p in tool.PREFIXES)
    assert [r["iteration"] for r in gen["rows"]] == [1000, 2000, 3000] and gen["complete"]
    assert gen["best"]["iteration"] == 1000
    assert [r["fid"] for r in ema["rows"]] == [9.0, 2.0] and ema["complete"] is False
    assert tool.main(["recover", "--work", str(work.root), "--device", "cpu"])["recover"] == {
        p: {"skipped": True} for p in tool.PREFIXES}


def test_all_score_after_scores_every_snapshot_after_training(tmp_path, monkeypatch):
    """`all --score_after --score_on 0,1,2`: the classifier and calibration
    in a child on card 2 beside training, then three scorers (here threads),
    one a card, each over its interleaved share in one sweep a family, their
    parts merged into both curves; then `report`. alongside.json keeps the
    placement, a backlog of every snapshot, each scorer's seconds and the
    seconds from the end of training to the last row."""
    import threading

    fake = _FakeEntryPoints(monkeypatch)
    docs = tmp_path / "docs"
    monkeypatch.setattr(tool, "DOCS", docs)
    monkeypatch.setattr(tool, "SCORER_POLL", 0.01)
    children = []

    class _Child:
        def __init__(self, cmd, cwd, env, stdout, stderr):
            children.append((cmd, env))
            self.thread = threading.Thread(target=tool.main, args=(cmd[2:],))
            self.thread.start()

        def poll(self):
            return None if self.thread.is_alive() else 0

        def wait(self, timeout=None):
            self.thread.join(timeout)
            return self.poll()

        returncode = property(poll)

    monkeypatch.setattr(tool.subprocess, "Popen", _Child)
    w = tmp_path / "w"
    out = tool.main(["all", "--score_after", "--work", str(w), "--device", "cpu",
                     "--iters", "3000", "--score_on", "0,1,2", "--scorer_threads", "8"])
    base = ["--work", str(w), "--device", "cpu", "--data_root", str(w / "data")]
    assert [(c[2:], e["CUDA_VISIBLE_DEVICES"], e["OMP_NUM_THREADS"]) for c, e in children] == [
        (["classifier"] + base, "2", "8")] + [
        (["score"] + base + ["--worker", str(k)], str(k), "8") for k in range(3)]
    kinds = [c[0] for c in fake.calls]
    assert kinds.index("train") < kinds.index("fid_curve") and kinds.count("fid_curve") == 6
    assert kinds.count("inception") == kinds.count("calibrate") == 1
    plan = json.loads((w / "score_plan.json").read_text())["workers"]
    assert [[tuple(x) for x in p["share"]] for p in plan] == [
        [("gen", 1000), ("ema", 2000)], [("ema", 1000), ("gen", 3000)],
        [("gen", 2000), ("ema", 3000)]]
    for k, rec in enumerate(out["score"]):
        assert rec["worker"] == k and set(rec["sweeps"]) == set(tool.PREFIXES)
        for p, sweep in rec["sweeps"].items():
            assert sweep["argv"][sweep["argv"].index("--run_dir") + 1] == str(w / "score" / str(k))
            assert "--start_after" not in sweep["argv"]
            assert sweep["scored"] == [it for q, it in plan[k]["share"] if q == p]
    for p in tool.PREFIXES:
        doc = json.loads(tool.Work.at(w).curve(p).read_text())
        assert doc["rows"] == _recorded(p)["rows"][:3] and doc["complete"] is True
    along = json.loads((w / "alongside.json").read_text())
    assert along["mode"] == "score_after" and along["placement"]["classifier"] == "2"
    assert [s["card"] for s in along["placement"]["scorers"]] == ["0", "1", "2"]
    assert along["unscored_at_train_end"] == along["snapshots_at_train_end"] == {
        "gen": 3, "ema": 3}
    assert sorted(s["worker"] for s in along["scorers"]) == [0, 1, 2]
    assert all(s["exit"] == 0 and s["snapshots"] == 2 for s in along["scorers"])
    assert along["seconds_from_train_end_to_last_row"] is not None
    assert along["classifier"]["seconds"] >= 0 and along["scorer_threads"] == 8
    assert out["report"]["alongside"] == along
    assert out["report"]["curves"]["gen"]["iterations"] == [1000, 2000, 3000]
    assert sorted(p.name for p in docs.iterdir()) == [
        "fid_curve_ema.json", "fid_curve_gen.json", "summary.json"]


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A tiny config's work directory with three gen and three ema
    snapshots (distinct random generators) on PNG folders, scored at the
    `--smoke` protocol with `tests/torch_scorer_stub.py`'s scorer: once in
    one sweep a family in this process, and once by `score_after` with two
    scorers, each a separate process on the CPU."""
    import argparse
    import shutil

    import numpy as np
    from PIL import Image

    from aclgan_tpu_torch import config
    from aclgan_tpu_torch.cli import fid_curve
    from aclgan_tpu_torch.trainer import ACLGAN
    from aclgan_tpu_torch.utils.checkpoint import save_generators
    from tests.helpers import tiny_config
    from tests.torch_scorer_stub import PixelScorer

    root = tmp_path_factory.mktemp("score_after")
    w = root / "w"
    rng = np.random.RandomState(0)
    for sub in ("testA", "testB"):
        (w / "data" / sub).mkdir(parents=True)
        for i in range(12):
            Image.fromarray(rng.randint(0, 256, (18, 20, 3), dtype=np.uint8)).save(
                w / "data" / sub / f"{i}.png")
    cfg = tiny_config()
    cfg.data.synthetic, cfg.data.data_root, cfg.data.input_dim_b = False, str(w / "data"), 3
    config.save_config(config.from_dict(cfg.to_dict()), w / "synthfaces_hard.yaml")
    work = tool.Work.at(w)
    work.checkpoints.mkdir(parents=True)
    model = ACLGAN(config.load_config(work.config), device="cpu")
    for seed, (p, it) in enumerate((p, it) for it in (2, 4, 6) for p in tool.PREFIXES):
        ACLGAN.__init__(model, config.load_config(work.config), device="cpu", seed=seed)
        save_generators(str(work.checkpoints / f"{p}_{it:08d}.pt"), model)
    work.inception.write_bytes(b"")
    args = argparse.Namespace(device="cpu", smoke=True, inception_weights=None,
                              scorer_threads=2, worker=None)
    one = root / "one"
    shutil.copytree(w, one, symlinks=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(tool, "ensure_config", lambda work, sizes: config.load_config(work.config))
    mp.setattr(fid_curve, "InceptionScorer", PixelScorer)
    mp.setattr(tool, "SCORER_POLL", 0.1)
    try:
        import torch

        threads = torch.get_num_threads()
        torch.set_num_threads(args.scorer_threads)
        try:
            tool.stage_curves(tool.Work.at(one), tool.SMOKE, args)
        finally:
            torch.set_num_threads(threads)
        mp.setattr(tool.subprocess, "Popen", _StubbedPopen)
        record = {"placement": {}, "scorers": []}
        t_end = tool.time.time()
        recs = tool.score_after(work, tool.SMOKE, args, [None, None], record, t_end, [])
    finally:
        mp.undo()
    return work, tool.Work.at(one), args, record, recs


class _StubbedPopen(subprocess.Popen):
    """The tool's child process, run through `tests/torch_scorer_stub.py`."""

    def __init__(self, cmd, **kw):
        super().__init__([cmd[0], str(ROOT / "tests" / "torch_scorer_stub.py"), *cmd[2:]], **kw)


def test_score_after_in_two_processes_equals_one_sweep(scored):
    """Two scorer processes, one family each, merged: both curve files
    equal the one-process sweep's, key for key (rows, best, protocol,
    complete)."""
    work, one, _, record, recs = scored
    for p in tool.PREFIXES:
        got, want = (json.loads(w.curve(p).read_text()) for w in (work, one))
        assert [r["iteration"] for r in want["rows"]] == [2, 4, 6] and want["complete"]
        assert got == want
    assert [r["share"] for r in recs] == [[["gen", 2], ["gen", 4], ["gen", 6]],
                                          [["ema", 2], ["ema", 4], ["ema", 6]]]
    for rec, p in zip(recs, tool.PREFIXES):
        assert list(rec["sweeps"]) == [p] and len(rec["sweeps"][p]["seconds_a_snapshot"]) == 3
        assert rec["sweeps"][p]["derived"]["k2"] == rec["sweeps"][p]["launches"]["k2"] == 0
    assert sorted((s["worker"], s["exit"], s["log"]) for s in record["scorers"]) == [
        (0, 0, "score_0.log"), (1, 0, "score_1.log")]
    assert record["seconds_from_train_end_to_last_row"] > 0
    sweeps = json.loads(work.log("curves_log").read_text())["sweeps"]
    assert sorted((s["worker"], s["prefix"]) for s in sweeps) == [(0, "gen"), (1, "ema")]


def test_a_sweep_after_score_after_resumes_after_the_merged_rows(scored, tmp_path):
    """`curves` over a curve that `score_after` merged resumes with
    `--start_after` its last row and scores only the newer snapshots."""
    import shutil

    from aclgan_tpu_torch import config
    from aclgan_tpu_torch.cli import fid_curve
    from tests.torch_scorer_stub import PixelScorer

    work, _, args, _, _ = scored
    w = tool.Work.at(shutil.copytree(work.root, tmp_path / "w"))
    for p in tool.PREFIXES:
        shutil.copy(w.checkpoints / f"{p}_00000006.pt", w.checkpoints / f"{p}_00000008.pt")
    mp = pytest.MonkeyPatch()
    mp.setattr(tool, "ensure_config", lambda work, sizes: config.load_config(work.config))
    mp.setattr(fid_curve, "InceptionScorer", PixelScorer)
    try:
        sweeps = tool.stage_curves(w, tool.SMOKE, args)
    finally:
        mp.undo()
    for p in tool.PREFIXES:
        argv = sweeps[p]["argv"]
        assert argv[argv.index("--start_after") + 1] == "6" and sweeps[p]["scored"] == [8]
        doc = json.loads(w.curve(p).read_text())
        assert [r["iteration"] for r in doc["rows"]] == [2, 4, 6, 8] and doc["complete"]
        assert doc["rows"][:3] == json.loads(work.curve(p).read_text())["rows"]


def test_a_failed_scorer_fails_the_stage_and_names_its_log(scored, tmp_path):
    """A scorer whose share holds a broken snapshot file fails after its
    first row: the stage raises naming its log once the other scorer has
    ended, and both scorers' rows are merged."""
    import shutil

    work, _, args, _, _ = scored
    w = tool.Work.at(shutil.copytree(work.root, tmp_path / "w"))
    shutil.rmtree(w.root / "score")  # else its parts hold every row: nothing left to score
    for p in tool.PREFIXES:
        w.curve(p).unlink()
    (w.checkpoints / "ema_00000004.pt").write_bytes(b"not a snapshot")
    mp = pytest.MonkeyPatch()
    mp.setattr(tool.subprocess, "Popen", _StubbedPopen)
    mp.setattr(tool, "SCORER_POLL", 0.1)
    record = {"placement": {}, "scorers": []}
    try:
        with pytest.raises(RuntimeError, match=r"the score stage failed \{'score_1': 1\}; "
                                               rf"see {w.root / 'score_1.log'}"):
            tool.score_after(w, tool.SMOKE, args, [None, None], record, tool.time.time(), [])
    finally:
        mp.undo()
    assert "Traceback" in (w.root / "score_1.log").read_text()
    assert [r["iteration"] for r in json.loads(w.curve("gen").read_text())["rows"]] == [2, 4, 6]
    ema = json.loads(w.curve("ema").read_text())
    assert [r["iteration"] for r in ema["rows"]] == [2] and ema["complete"] is False
    assert sorted((s["worker"], s["exit"]) for s in record["scorers"]) == [(0, 0), (1, 1)]
