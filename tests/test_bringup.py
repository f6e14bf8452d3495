"""The GPU bring-up's host-side code on the CPU: ``chip_smoke.py``'s guard
and helpers, the retired engine options, the dependency-free config reader
and CSV writers (against PyYAML and pandas), the compile-cache rule, the
device checks, and a driver run with the optional packages blocked."""

import glob
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
import yaml

import chip_smoke
from heatflow_tpu.config import (ConfigError, dump_yaml, load_yaml,
                                 parse_yaml, save_config)
from heatflow_tpu.io.csvio import (read_gradient_csv, read_numeric_columns,
                                   read_records_csv, write_gradient_csv,
                                   write_records_csv, write_watcher_csv)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = sorted(glob.glob(os.path.join(ROOT, "cfgs", "*.yaml"))) + [
    os.path.join(ROOT, "simulation_template.yaml")]
CSV_FILES = sorted(glob.glob(os.path.join(ROOT, "experimental_data",
                                          "*.csv")))


# ------------------------------------------------------------ chip_smoke

def test_chip_smoke_device_guard_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()


def test_chip_smoke_result_line():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_chip_smoke_truth_comparisons():
    truth = np.array([[300.0, 310.0], [320.0, 330.0]])
    got = truth + np.array([[0.5, -1.5], [0.0, 0.25]])
    assert chip_smoke.max_abs_error(got, truth) == 1.5
    expect = np.linalg.norm(got - truth) / np.linalg.norm(truth)
    assert chip_smoke.rel_l2(got, truth) == pytest.approx(expect, rel=1e-15)
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.max_abs_error(got[:1], truth)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.rel_l2(np.where(got > 320, np.nan, got), truth)
    chip_smoke.check("within", 1.0, 2.0)
    with pytest.raises(AssertionError, match="exceeds"):
        chip_smoke.check("over", 2.5, 2.0)
    with pytest.raises(AssertionError, match="exceeds"):
        chip_smoke.check("nan", float("nan"), 2.0)


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    """Alone in a directory, the script exits non-zero and prints no ok
    line (here the device guard stops it before anything else)."""
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ------------------------------------------------------ retired options

@pytest.mark.parametrize("module,argv", [
    ("run2d", ["--solver", "vmem"]),
    ("run2d", ["--precondition", "adaptive"]),
    ("run2d", ["--precondition", "mgz"]),
    ("sweep", ["--config", "c.yaml", "--output-dir", "o", "--solver",
               "vmem"]),
    ("sweep", ["--config", "c.yaml", "--output-dir", "o",
               "--precondition", "adaptive"]),
    ("fit", ["--config", "c.yaml", "--mesh-folder", "m", "--solver",
             "vmem"]),
])
def test_removed_cli_choices_rejected(module, argv, capsys):
    import importlib
    main = importlib.import_module(f"heatflow_tpu.drivers.{module}").main
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_removed_maker_options_rejected():
    from heatflow_tpu.utils import resolve_solver
    with pytest.raises(ValueError, match="unknown solver 'vmem'"):
        resolve_solver("vmem")
    from heatflow_tpu.sim import stepper
    assert "adaptive" not in stepper.PRECONDITIONERS
    assert "mgz" not in stepper.PRECONDITIONERS


# ------------------------------------------------- config reader/writer

@pytest.mark.parametrize("path", YAML_FILES,
                         ids=[os.path.relpath(p, ROOT) for p in YAML_FILES])
def test_config_reader_and_writer_match_pyyaml(path, tmp_path):
    with open(path) as f:
        text = f.read()
    cfg = load_yaml(path)
    assert cfg == yaml.safe_load(text)
    out = tmp_path / "used_config.yaml"
    save_config(cfg, out)
    assert out.read_text() == yaml.safe_dump(cfg, default_flow_style=False)
    assert load_yaml(out) == cfg


def test_config_reader_scalars_match_pyyaml():
    text = textwrap.dedent("""\
        a: 20e-6
        b: 1.5e-05
        c: -3
        d: yes
        e: ~
        f: 'quoted: # not a comment'
        g: [1, 2.5, x]
        h: {}
        i: .inf
        j: "plain"   # trailing comment
        k:
        - 1.0
        - two
        """)
    assert parse_yaml(text) == yaml.safe_load(text)
    cfg = {"x": [1e-06, 2.5, 3], "y": {"z": None, "w": True}, "v": "1e-6",
           "u": "yes", "t": {}}
    assert dump_yaml(cfg) == yaml.safe_dump(cfg, default_flow_style=False)
    assert parse_yaml(dump_yaml(cfg)) == cfg


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n",            # anchors and aliases
    "a: |\n  block\n",             # block scalar
    "a: {b: 1}\n",                 # flow mapping
    "a:\n- - 1\n",                 # nested list
    "a: 0x1f\n",                   # hex
    "a: 1\na: 2\n",                # duplicate key
    "a: !!float 1\n",              # tag
])
def test_config_reader_rejects_what_it_does_not_take(text):
    with pytest.raises(ConfigError):
        parse_yaml(text)


def test_structured_mesh_reload_keeps_tag_order(tmp_path):
    """A mesh re-read from mesh_cfg.yaml (keys written sorted) keeps its
    material tags in tag order — the stencil-slot order the sweep makers
    index the varied material by."""
    from heatflow_tpu.geometry import build_layout
    from heatflow_tpu.mesh.structured import (build_structured_mesh,
                                              mesh_from_meta)
    from tests.fixtures import tiny_no_diamond_cfg
    domain, mats = build_layout(tiny_no_diamond_cfg(coarse=3.0))
    mesh = build_structured_mesh(domain, mats)
    save_config({"structured_grid": mesh.to_meta()}, tmp_path / "m.yaml")
    back = mesh_from_meta(load_yaml(tmp_path / "m.yaml")["structured_grid"],
                          materials=mats)
    assert list(back.material_tags.items()) \
        == list(mesh.material_tags.items())
    assert list(back.material_tags.values()) == sorted(
        back.material_tags.values())


# ------------------------------------------------------------ CSV I/O

def _read_any(path):
    with open(path) as f:
        headed = not f.readline()[0].isdigit()
    df = pd.read_csv(path, header=0 if headed else None)
    if not headed:
        df.columns = ["time"] + [f"c{j}" for j in range(1, df.shape[1])]
    return df.apply(pd.to_numeric, errors="coerce")


@pytest.mark.parametrize("path", CSV_FILES,
                         ids=[os.path.basename(p) for p in CSV_FILES])
def test_csv_writers_match_pandas(path, tmp_path):
    df = _read_any(path)
    times = df["time"].to_numpy()
    names = [c for c in df.columns if c != "time"]
    for dtype in (np.float64, np.float32):
        traces = {n: df[n].to_numpy().astype(dtype) for n in names}
        ours = tmp_path / "watcher_points.csv"
        write_watcher_csv(str(ours), times, traces)
        ref = pd.DataFrame({"time": times})
        for n, v in traces.items():
            ref[n] = v
        assert ours.read_text() == ref.to_csv(index=False)

        rows = np.stack([traces[n] for n in names], axis=1)
        zs = np.linspace(-2e-6, 3e-6, rows.shape[1])
        ours = tmp_path / "radial_gradient.csv"
        write_gradient_csv(str(ours), times, zs, rows)
        ref = pd.DataFrame(rows, columns=list(zs))
        ref.index = list(times)
        ref.index.name = "time"
        assert ours.read_text() == ref.to_csv()
        t2, z2, v2 = read_gradient_csv(str(ours))
        back = pd.read_csv(ours, index_col=0, float_precision="round_trip")
        np.testing.assert_array_equal(t2, back.index.to_numpy(float))
        np.testing.assert_array_equal(z2, back.columns.to_numpy(float))
        np.testing.assert_array_equal(v2, back.to_numpy(float))


@pytest.mark.parametrize("path", [p for p in CSV_FILES
                                  if "heat_data" in p],
                         ids=lambda p: os.path.basename(p))
def test_csv_reader_matches_pandas(path):
    from heatflow_tpu.sim.bc import HeatingCurve
    cols = read_numeric_columns(path)
    # correctly rounded parsing (pandas' default fast parser can be 1 ulp
    # off; Python's float() is exact)
    df = pd.read_csv(path, float_precision="round_trip")
    assert list(cols) == list(df.columns)
    for name in cols:
        np.testing.assert_array_equal(
            cols[name], pd.to_numeric(df[name], errors="coerce").to_numpy())
    hc = HeatingCurve.from_csv(path)
    ref = df.dropna(subset=["time", "temp"]).sort_values("time")
    np.testing.assert_array_equal(hc.time, ref["time"].to_numpy(float))
    np.testing.assert_array_equal(hc.temp, ref["temp"].to_numpy(float))
    np.testing.assert_array_equal(hc.oside, ref["oside"].to_numpy(float))


def test_records_csv_matches_pandas(tmp_path):
    records = [{"run_id": 1, "run_name": "a", "fwhm": 1.5e-06, "k": 3.8,
                "runtime": None, "status": "success", "error": None},
               {"run_id": 2, "run_name": "b", "fwhm": 2e-05, "k": 100.0,
                "runtime": 0.25, "status": "failed",
                "error": "non-finite trace"}]
    path = tmp_path / "runs.csv"
    write_records_csv(str(path), records)
    assert path.read_text() == pd.DataFrame(records).to_csv(index=False)
    back = read_records_csv(str(path))
    assert back[1]["error"] == "non-finite trace" and back[0]["error"] is None
    assert back[0]["fwhm"] == 1.5e-06 and back[1]["run_id"] == 2


# --------------------------------------------------------- compile cache

def _cache_probe(tmp_path, env_dir):
    """Run a driver's main in a fresh process and report the compile-cache
    directory JAX ends up with."""
    code = textwrap.dedent("""
        import jax
        from heatflow_tpu.drivers import run2d
        try:
            run2d.main(["--config", "missing.yaml"])
        except FileNotFoundError:
            pass
        print("CACHE", jax.config.jax_compilation_cache_dir)
        """)
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return out.split("CACHE ", 1)[1].strip()


def test_cache_dir_from_environment_is_kept(tmp_path):
    env_dir = str(tmp_path / "cache_from_env")
    assert _cache_probe(tmp_path, env_dir) == env_dir


def test_cache_dir_defaults_to_checkout(tmp_path):
    assert _cache_probe(tmp_path, None) == os.path.join(ROOT, ".jax_cache")


def test_only_the_helper_sets_a_cache_dir():
    """No module, script or benchmark sets the cache directory itself."""
    hits = []
    paths = glob.glob(os.path.join(ROOT, "*.py")) + [
        p for d in ("heatflow_tpu", "benchmarks", "examples")
        for p in glob.glob(os.path.join(ROOT, d, "**", "*.py"),
                           recursive=True)]
    for path in paths:
        rel = os.path.relpath(path, ROOT)
        with open(path) as f:
            if "jax_compilation_cache_dir" in f.read():
                hits.append(rel)
    assert hits == [os.path.join("heatflow_tpu", "utils.py")]


# ---------------------------------------------------------- device checks

@pytest.mark.parametrize("name", ["combine_has_no_dot",
                                  "normal_equations_precision",
                                  "cg_matches_direct",
                                  "refined_solve_matches_direct"])
def test_device_check_on_cpu(name):
    from heatflow_tpu.devicecheck import CHECKS
    assert CHECKS[name]() >= 0.0


# ------------------------------------------- driver without the extras

def test_run2d_runs_without_optional_packages(tmp_path):
    """yaml, pandas, h5py and matplotlib blocked: a tiny run2d still runs
    end to end and writes its CSV and YAML artifacts."""
    from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg
    heat = tmp_path / "heat.csv"
    synthetic_heating(heat)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat)
    cfg["timing"]["num_steps"] = 3
    save_config(cfg, tmp_path / "cfg.yaml")
    code = textwrap.dedent(f"""
        import sys
        for name in ("yaml", "pandas", "h5py", "matplotlib"):
            sys.modules[name] = None
        from heatflow_tpu.drivers import run2d
        run2d.main(["--config", "cfg.yaml", "--mesh-folder", "m",
                    "--rebuild-mesh", "--output-folder", "out",
                    "--watcher-points", "auto", "--suppress-print"])
        import os
        print(sorted(os.listdir("out")))
        """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for name in ("watcher_points.csv", "radial_gradient.csv",
                 "used_config.yaml", "checkpoint.npz"):
        assert name in proc.stdout
    assert load_yaml(tmp_path / "out" / "used_config.yaml") == cfg
    watch = read_numeric_columns(str(tmp_path / "out"
                                     / "watcher_points.csv"))
    assert list(watch) == ["time", "pside", "oside"]
    assert np.isfinite(watch["oside"]).all()
