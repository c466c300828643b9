"""The kernel build's bookkeeping (ops/_build.py), with a stand-in for nvcc:
one compile per source, a link only of what compiled, nothing left behind
by a failed build, and reuse of a finished library. The real compiler runs
on the card only (chip_smoke.py phase 2)."""

import stat

import pytest

from slam_decomposition_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
# stand-in compiler: records its arguments, writes its -o file, fails on request
echo "$@" >> "{log}"
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case " $* " in
  *" -shared "*) echo "link report"; : > "$out"; [ -e "{dir}/fail_link" ] && exit 1;;
  *lm_chain.cu*) echo "ptxas report lm"; [ -e "{dir}/fail_compile" ] && exit 1; : > "$out";;
  *) echo "ptxas report"; : > "$out";;
esac
exit 0
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=tmp_path / "calls.txt", dir=tmp_path))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "out")
    return tmp_path


def _calls(fake):
    return (fake / "calls.txt").read_text().splitlines()


def test_build_compiles_each_source_once_links_and_reuses(fake):
    info = _build.build()
    sources = sorted(f.name for f in _build.CSRC.glob("*.cu"))
    compiles = [c for c in _calls(fake) if " -c " in f" {c} "]
    assert sorted(c.split("/")[-1] for c in compiles) == sources
    assert sum(" -shared " in f" {c} " for c in _calls(fake)) == 1
    assert info["path"].exists() and info["seconds"] > 0 and "ptxas report lm" in info["ptxas"]
    # only the library and its report stay
    assert sorted(p.name for p in (fake / "out").iterdir()) == sorted(
        [info["path"].name, info["path"].with_suffix(".ptxas.txt").name])
    again = _build.build()
    assert again["seconds"] == 0.0 and again["ptxas"] == info["ptxas"] and len(_calls(fake)) == len(sources) + 1


@pytest.mark.parametrize("stage", ["compile", "link"])
def test_failed_build_raises_and_leaves_nothing(fake, stage):
    (fake / f"fail_{stage}").touch()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    # a failed compile is not linked; a failed link's output is removed
    assert sum(" -shared " in f" {c} " for c in _calls(fake)) == (0 if stage == "compile" else 1)
    assert list((fake / "out").iterdir()) == []
