"""kernels/_build.py driven on the host with a stand-in nvcc (a shell script
that writes its -o file), so no CUDA toolkit is needed: one compile per
source, then one link; a failed compile raises with the compiler's output."""

import pytest

from genomicbreedingmodels_tpu_torch.kernels import _build


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        'case "$*" in *broken.cu*) echo "broken.cu(1): error: expected a declaration" >&2; exit 2;; esac\n'
        'echo "ptxas info    : Used 40 registers"\n'
        'echo "$@" > "$out"\n'
    )
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    return csrc, tmp_path / "build"


def test_build_compiles_each_source_then_links(fake_tree):
    csrc, out_dir = fake_tree
    lib = _build.build()
    assert lib.is_file() and lib.parent == out_dir
    link = lib.read_text().split()  # the stand-in writes its arguments
    assert "-shared" in link and len([a for a in link if a.endswith(".o")]) == 2
    log = next(out_dir.glob("build_*.log")).read_text()
    assert log.count(" -c ") == 2 and "registers" in log
    assert not list(out_dir.glob("*.o")) and not list(out_dir.glob("*.tmp"))
    assert _build.build() == lib  # unchanged sources reuse the library
    (csrc / "a.cu").write_text("// edited\n")
    assert _build.build() != lib


def test_build_failure_raises_with_compiler_output(fake_tree):
    csrc, out_dir = fake_tree
    (csrc / "broken.cu").write_text("oops\n")
    with pytest.raises(RuntimeError, match="expected a declaration"):
        _build.build()
    assert not list(out_dir.glob("*.so")) and not list(out_dir.glob("*.o"))


def test_count_launch_records_shapes_and_reset_clears_them(monkeypatch):
    """A launch counted with its operand's (dtype, n, p) lands in
    LAUNCH_SHAPES beside the count; reset_launches clears both."""
    monkeypatch.setattr(_build, "LAUNCHES", {"k": 0})
    monkeypatch.setattr(_build, "LAUNCH_SHAPES", {"k": set()})
    _build.count_launch("k", ("int8", 9000, 102000))
    _build.count_launch("k", ("int8", 9000, 102000))
    _build.count_launch("k")
    assert _build.LAUNCHES["k"] == 3
    assert _build.LAUNCH_SHAPES["k"] == {("int8", 9000, 102000)}
    _build.reset_launches()
    assert _build.LAUNCHES["k"] == 0 and not _build.LAUNCH_SHAPES["k"]
