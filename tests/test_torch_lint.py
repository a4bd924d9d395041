"""The port's static tiers (ceph_tpu_torch/analysis) against the
reference's (ceph_tpu/analysis), and the port's tree under its own tiers.

- every file of tests/lint_fixtures/: the AST, conc and det tiers give
  the same findings as the reference's (rule, line, column, message,
  live, suppressed and stale), the port's tiers reading a copy with its
  ``ceph_tpu.`` imports pointed at the port;
- the inline fixtures of tests/test_concurrency_lint.py and
  tests/test_determinism_lint.py (every source string in them, its
  ``ceph_tpu.`` imports and paths pointed at the port) give the same
  findings under the same registries and paths;
- the CLI (``python -m ceph_tpu_torch.tools.lint``) prints the same
  JSON as tools/tpu_lint.py on the fixture directory and exits with the
  same codes on red, green, stale and injected-fault trees;
- the gate: ceph_tpu_torch/ has zero unsuppressed findings in all three
  tiers, no stale pragma, a reason on every suppression, and no jit
  region (the port has no jax);
- ``--trace`` is the port's registry audit (``--device cpu`` here).

The tiers are pure ``ast``: no test here imports jax.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ceph_tpu.analysis import concurrency as ref_conc
from ceph_tpu.analysis import determinism as ref_det
from ceph_tpu.analysis import scanner as ref_scanner
from ceph_tpu.analysis.report import render_rules as ref_render_rules
from ceph_tpu_torch.analysis import concurrency as port_conc
from ceph_tpu_torch.analysis import determinism as port_det
from ceph_tpu_torch.analysis import scanner as port_scanner
from ceph_tpu_torch.analysis.jitregions import RegionAnalyzer
from ceph_tpu_torch.analysis.report import render_rules
from ceph_tpu_torch.tools import lint as port_cli

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "lint_fixtures"
PORT = ROOT / "ceph_tpu_torch"
REF_CLI = str(ROOT / "tools" / "tpu_lint.py")
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.py"))


def _dicts(findings):
    return [f.as_dict() for f in findings]


def _report(rep):
    return {"findings": _dicts(rep.findings),
            "suppressed": _dicts(rep.suppressed),
            "stale": _dicts(rep.stale)}


def _to_port(text: str) -> str:
    """A reference fixture with its package pointed at the port."""
    return text.replace("ceph_tpu.", "ceph_tpu_torch.") \
        .replace("ceph_tpu/", "ceph_tpu_torch/")


@pytest.fixture(scope="module")
def ported(tmp_path_factory):
    """A copy of tests/lint_fixtures/ pointed at the port, under the same
    directory name, so that its findings' paths read as the
    reference's when both are scanned from their parent."""
    d = tmp_path_factory.mktemp("port") / FIXTURES.name
    d.mkdir()
    for name in FIXTURE_FILES:
        (d / name).write_text(_to_port((FIXTURES / name).read_text()))
    return d


def _same_paths(rep, path: str):
    """``_report(rep)`` with every finding's path set to ``path``."""
    return {k: [dict(f, path=path) for f in v]
            for k, v in _report(rep).items()}


# ----------------------------------------------------------------------
# tests/lint_fixtures: the three tiers, file by file

@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_ast_tier_equals_reference(name, ported):
    port = port_scanner.lint_file(str(ported / name))
    ref = ref_scanner.lint_file(str(FIXTURES / name))
    assert _same_paths(port, name) == _same_paths(ref, name)


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_det_tier_equals_reference(name, ported):
    port = port_det.lint_det_paths([str(ported / name)],
                                   check_suppressions=True)
    ref = ref_det.lint_det_paths([str(FIXTURES / name)],
                                 check_suppressions=True)
    assert _same_paths(port, name) == _same_paths(ref, name)


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_conc_tier_equals_reference(name, ported):
    port = port_conc.lint_conc_paths([str(ported / name)],
                                     registry_ranks={}, registry_specs=[],
                                     check_suppressions=True)
    ref = ref_conc.lint_conc_paths([str(FIXTURES / name)],
                                   registry_ranks={}, registry_specs=[],
                                   check_suppressions=True)
    assert _same_paths(port, name) == _same_paths(ref, name)


# ----------------------------------------------------------------------
# the inline fixtures of the reference's conc and det tests

def _sources(test_file: str) -> list:
    """Every string constant of ``test_file`` that parses as a module of
    more than one line: the inline fixture sources."""
    tree = ast.parse((ROOT / "tests" / test_file).read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.count("\n") > 1:
            try:
                ast.parse(node.value)
            except SyntaxError:
                continue
            if node.value not in out:
                out.append(node.value)
    return out


def _rels(test_file: str) -> list:
    """The ``rel=`` paths the test file scans its fixtures under."""
    tree = ast.parse((ROOT / "tests" / test_file).read_text())
    rels = {"mod.py"}
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "rel" \
                and isinstance(node.value, ast.Constant):
            rels.add(node.value.value)
    return sorted(rels)


CONC_SOURCES = [s for s in _sources("test_concurrency_lint.py")
                if "lock" in s.lower() or "threading" in s]
DET_SOURCES = _sources("test_determinism_lint.py")
DET_RELS = _rels("test_determinism_lint.py")


def _conc(mod, sources, ranks):
    model = mod.ConcModel(registry_ranks=dict(ranks), registry_specs=[])
    for rel, src in sources:
        assert model.add_source(src, rel) is None
    model.analyze()
    return sorted((f.path, f.rule, f.line, f.col, f.end_line, f.message)
                  for fs in model.findings.values() for f in fs), \
        sorted(model.locks), sorted((e.src, e.dst) for e in model.edges)


def _conc_pair(sources, registry: str):
    """(reference, port) findings, locks and edges of ``sources`` under
    a registry: none, every lock ranked in order, or ranked in reverse."""
    port_sources = [(_to_port(rel), _to_port(src)) for rel, src in sources]
    ids = _conc(ref_conc, sources, {})[1]
    ranks = {} if registry == "empty" else {
        lid: (10 * (i + 1) if registry == "ascending" else 10 * (len(ids) - i))
        for i, lid in enumerate(ids)}
    ref = _conc(ref_conc, sources, ranks)
    ref = ([(_to_port(f[0]),) + f[1:] for f in ref[0]],) + ref[1:]
    return ref, _conc(port_conc, port_sources, ranks)


@pytest.mark.parametrize("registry", ["empty", "ascending", "descending"])
@pytest.mark.parametrize("i", range(len(CONC_SOURCES)))
def test_inline_conc_fixture_equals_reference(i, registry):
    ref, port = _conc_pair([("mod.py", CONC_SOURCES[i])], registry)
    assert port == ref


def test_inline_conc_cross_module_pair_equals_reference():
    """The call-graph edge across two package modules (the reference's
    low/high pair), with every source of the file beside them."""
    tree = ast.parse((ROOT / "tests" / "test_concurrency_lint.py")
                     .read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "test_cross_module_edge_through_call_graph")
    named = {t.id: n.value.value for n in ast.walk(fn)
             if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
             for t in n.targets if isinstance(t, ast.Name)}
    pair = [("ceph_tpu/low.py", named["low"]),
            ("ceph_tpu/high.py", named["high"])]
    for registry in ("empty", "ascending", "descending"):
        ref, port = _conc_pair(pair, registry)
        assert port == ref
        assert ref[2], "the pair has a cross-module edge"


def _det(mod, src, rel):
    model = mod.DetModel()
    assert model.add_source(src, rel) is None
    model.analyze()
    return sorted((f.rule, f.line, f.col, f.end_line, f.message)
                  for fs in model.findings.values() for f in fs)


@pytest.mark.parametrize("i", range(len(DET_SOURCES)))
def test_inline_det_fixture_equals_reference(i):
    src = DET_SOURCES[i]
    for rel in DET_RELS:
        ref = _det(ref_det, src, rel)
        port = _det(port_det, _to_port(src), _to_port(rel))
        assert port == ref, rel


def test_inline_fixtures_were_found():
    assert len(CONC_SOURCES) >= 15 and len(DET_SOURCES) >= 15
    assert "ceph_tpu/serve/fresh.py" in DET_RELS


# ----------------------------------------------------------------------
# the CLI against tools/tpu_lint.py

def _cli(argv, port: bool, cwd=ROOT):
    cmd = [sys.executable, "-m", "ceph_tpu_torch.tools.lint"] if port \
        else [sys.executable, REF_CLI]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run(cmd + list(argv), capture_output=True, text=True,
                          timeout=120, cwd=cwd, env=env)


@pytest.mark.parametrize("tier", [[], ["--conc"], ["--det"]])
def test_cli_json_equals_reference_on_fixtures(tier, ported):
    argv = tier + ["--json", "--check-suppressions", FIXTURES.name]
    ref = _cli(argv, False, cwd=FIXTURES.parent)
    port = _cli(argv, True, cwd=ported.parent)
    assert port.returncode == ref.returncode
    assert json.loads(port.stdout) == json.loads(ref.stdout)
    # the fixtures' red files fail the AST and det tiers; the conc tier
    # finds no lock in them
    assert ref.returncode == (0 if tier == ["--conc"] else 1)


INJECTED = '''
import jax
import jax.numpy as jnp
import numpy as np

@jax.jit
def encode(chunks):
    scaled = chunks.astype(np.float32)    # float GF intermediate
    host = np.asarray(chunks)             # host sync inside jit
    return scaled, host
'''


def _tree(tmp_path, case: str) -> Path:
    d = tmp_path / case
    if case == "red":
        (d / "gf").mkdir(parents=True)
        (d / "gf" / "injected.py").write_text(INJECTED)
    elif case == "green":
        d.mkdir()
        (d / "fine.py").write_text("x = 1\n")
    else:
        d.mkdir()
        shutil.copy(FIXTURES / f"stale_suppression_{case}.py", d / "mod.py")
    return d


@pytest.mark.parametrize("case", ["red", "green", "bad", "ok"])
@pytest.mark.parametrize("flags", [[], ["--check-suppressions"],
                                   ["--json", "--check-suppressions"]])
def test_cli_exit_codes_equal_reference(tmp_path, case, flags):
    d = str(_tree(tmp_path, case))
    ref, port = _cli(flags + [d], False), _cli(flags + [d], True)
    assert port.returncode == ref.returncode
    if "--json" in flags:
        assert json.loads(port.stdout) == json.loads(ref.stdout)
    want = {"red": 1, "green": 0, "ok": 0,
            "bad": 1 if "--check-suppressions" in flags else 0}[case]
    assert port.returncode == want


def test_injected_fault_goes_red_in_process(tmp_path, capsys):
    d = _tree(tmp_path, "red")
    assert port_cli.main([str(d)]) == 1
    out = capsys.readouterr().out
    assert "gf-float" in out and "host-sync" in out


def test_cli_list_rules_equals_reference(capsys):
    assert port_cli.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.strip() == ref_render_rules()
    assert render_rules() == ref_render_rules()


def test_cli_rule_filter_and_show_suppressed(capsys):
    fixture = str(FIXTURES / "gf_float_suppressed.py")
    assert port_cli.main(["--show-suppressed", fixture]) == 0
    assert "[suppressed (" in capsys.readouterr().out
    bad = str(FIXTURES / "gf_float_bad.py")
    assert port_cli.main(["--rule", "host-sync", bad]) == 0
    assert port_cli.main(["--rule", "gf-float", bad]) == 1


# ----------------------------------------------------------------------
# the port's tree under its own tiers

def test_port_tree_is_lint_clean():
    rep = port_scanner.lint_paths([str(PORT)])
    assert rep.ok, "\n".join(f.render() for f in rep.findings)
    assert rep.stale == [], "\n".join(f.render() for f in rep.stale)
    assert len(rep.files) > 100
    for f in rep.suppressed:
        assert f.suppress_reason, f.render()


def test_port_tree_is_conc_clean():
    rep = port_conc.lint_conc_paths([str(PORT)], check_suppressions=True)
    assert rep.ok, "\n".join(f.render() for f in rep.findings)
    assert rep.stale == [], "\n".join(f.render() for f in rep.stale)
    for f in rep.suppressed:
        assert f.suppress_reason, f.render()


def test_port_tree_is_det_clean():
    rep = port_det.lint_det_paths([str(PORT)], check_suppressions=True)
    assert rep.ok, "\n".join(f.render() for f in rep.findings)
    assert rep.stale == [], "\n".join(f.render() for f in rep.stale)
    for f in rep.suppressed:
        assert f.suppress_reason, f.render()


def test_port_lock_graph_names_port_modules():
    model, _, errors = port_conc.scan_paths([str(PORT)])
    assert not errors
    ids = set(model.locks)
    assert "ops._build._lock" in ids and "parallel.plane._lock" in ids
    assert not any(i.startswith("ceph_tpu") for i in ids)


@pytest.mark.parametrize("tier", [[], ["--conc"], ["--det"]])
def test_port_cli_default_path_is_clean(tier, capsys):
    assert port_cli.main(tier + ["--check-suppressions"]) == 0
    assert " 0 findings" in capsys.readouterr().out


def test_jitregions_finds_no_region_in_the_port():
    """A deliberate difference: the port has no jax, so no jit region;
    the region rules act on the fixtures alone."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        assert RegionAnalyzer(tree).regions == {}, path
    tree = ast.parse((FIXTURES / "host_sync_bad.py").read_text())
    assert RegionAnalyzer(tree).regions


def test_module_names_are_relative_to_the_port():
    assert port_conc.module_name_for("ceph_tpu_torch/serve/queue.py") \
        == "serve.queue"
    assert port_conc.module_name_for("ceph_tpu_torch/__init__.py") \
        == "__init__"
    assert port_conc.module_name_for("tools/perf_dump.py") == "perf_dump"
    from ceph_tpu_torch.analysis import replaymodel
    assert replaymodel.domain_kind("tools.perf_dump") == "wallclock"
    assert replaymodel.domain_kind("perf_dump") == "wallclock"
    assert replaymodel.domain_kind("serve.batcher") == "replay"


# ----------------------------------------------------------------------
# --trace: the registry audit

def test_cli_trace_one_entry_on_the_cpu(capsys):
    assert port_cli.main(["--trace", "--entry", "ops.apply_matrix_best",
                          "--device", "cpu", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True and payload["tier"] == "trace"
    (entry,) = payload["entries"]
    assert entry["name"] == "ops.apply_matrix_best"
    assert entry["device"] == "cpu" and "numpy" in entry["tiers"]


def test_cli_trace_unknown_entry_and_list(capsys):
    assert port_cli.main(["--trace", "--entry", "no.such"]) == 2
    assert port_cli.main(["--list-entrypoints"]) == 0
    out = capsys.readouterr().out
    assert "ops.apply_matrix_best" in out and "setup_budget=" in out


def test_cli_trace_without_a_card_names_no_device_error(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert port_cli.main(["--trace", "--entry",
                          "ops.apply_matrix_best"]) == 1
    assert "NoDeviceError" in capsys.readouterr().err
