"""`tools/torch_synthfaces_hard.py`, the port's synthfaces_hard acceptance
run, on the CPU: its report on the JAX package's recorded curves, the
quality bars, the resume planners, the config guard, the protocol refusal
and the argv of every entry point the `all` plan calls (with the CLIs'
`main` functions replaced). No InceptionV3 forward and no 2048^2 sqrtm."""

import json
import subprocess
import sys
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


def test_all_alongside_scores_beside_training(tmp_path, monkeypatch):
    """`all --alongside`: the dataset, then `follow` in a second process (here
    a thread) with its BLAS threads capped while `train` runs, then `report`
    on both curves."""
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
                     "--iters", "3000"])
    (cmd, env), = children
    assert cmd[2:] == ["follow", "--work", str(w), "--device", "cpu", "--data_root",
                       str(w / "data")]
    assert env["OPENBLAS_NUM_THREADS"] == env["OMP_NUM_THREADS"] == str(tool.SCORER_THREADS)
    kinds = [c[0] for c in fake.calls]
    assert kinds[0] == "dataset" and kinds[-1] == "grid" and kinds.count("fid_curve") >= 2
    assert sorted(set(kinds)) == ["calibrate", "dataset", "fid_curve", "grid", "inception",
                                  "train"]
    assert (w / "train.done").exists()
    assert out["report"]["curves"]["gen"]["iterations"] == [1000, 2000, 3000]
    assert out["report"]["bars"]["ema_steadiness"]["snapshots"] == 0
    assert sorted(p.name for p in docs.iterdir()) == [
        "fid_curve_ema.json", "fid_curve_gen.json", "summary.json"]


def _snapshots(ckpt, stamps, families=("gen", "dis", "ema"), optimizer=True):
    ckpt.mkdir(parents=True, exist_ok=True)
    for s in stamps:
        for f in families:
            (ckpt / f"{f}_{s:08d}.pt").write_bytes(b"")
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
                "steps_per_second": 300.0}

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


def test_calibration_loads_each_side_as_the_curve_loads_its_real_side(tmp_path, monkeypatch):
    """FID(testA, testB) and FID(trainB[:n], testB) through
    `cli.fid_curve`'s loading: the source domain's size (a -> b), the first
    n images in order. trainB starts with testB's images, so the floor is 0."""
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
