"""The one ctypes binder of the port's kernels (`ops/_build.py`): a C entry
point's signature set once, a non-zero status raised, scratch sizes asked
once per shape. Run on the C library's own functions, so no CUDA is needed."""
import ctypes

import pytest

from nopesac_torch.ops import _build


@pytest.fixture
def libc(monkeypatch):
    monkeypatch.setattr(_build, "_LIBS", {"libc": ctypes.CDLL(None)})
    return "libc"


def test_entry_sets_the_signature_once_and_raises_on_a_status(libc):
    fn = _build.entry(libc, "abs", [ctypes.c_int])
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert fn(0) is None
    with pytest.raises(RuntimeError, match="abs: CUDA error 3 at launch"):
        fn(-3)
    assert _build.entry(libc, "abs", [ctypes.c_long]) is fn
    assert fn.argtypes == [ctypes.c_int]


def test_a_library_loaded_anew_is_bound_afresh(libc, monkeypatch):
    first = _build.entry(libc, "abs", [ctypes.c_int])
    monkeypatch.setattr(_build, "_LIBS", {libc: ctypes.CDLL(None)})
    again = _build.entry(libc, "abs", [ctypes.c_int])
    assert again is not first and again.argtypes == [ctypes.c_int]
    with pytest.raises(RuntimeError, match="CUDA error 5"):
        again(5)


@pytest.mark.parametrize("arg,want", [(-7, 7), (0, 0), (12, 12)])
def test_size_is_the_entry_points_count_asked_once_per_shape(libc, arg, want, monkeypatch):
    assert _build.size(libc, "abs", arg) == want
    fn = _build._LIBS[libc].abs
    assert fn.sizes == {(arg,): want} and fn.argtypes == [ctypes.c_int]
    fn.sizes[(arg,)] = -1  # a second call reads the count kept, not the library
    assert _build.size(libc, "abs", arg) == -1
    monkeypatch.setattr(_build, "_LIBS", {libc: ctypes.CDLL(None)})
    assert _build.size(libc, "abs", arg) == want  # a library loaded anew is asked afresh
