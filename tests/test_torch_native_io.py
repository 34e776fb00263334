"""The port's native audio IO against the JAX package's (CPU): the g++
build of ``native/*.cc`` into ``musicfpaugment_torch/build/``, the mp3
decode of ``tests/fixtures/tone.mp3`` bit for bit, native WAV against
scipy's WAV bit for bit, metadata, the threaded batch decoder with a
missing file, an encode -> decode round trip, and the audfprint and Dejavu
hashes of an mp3 file equal to JAX's.

The mp3 cases skip where libmpg123 cannot be loaded (as tests/test_mp3.py
does), the encoder cases where libmp3lame cannot.
"""

import importlib
import os

import numpy as np
import pytest
import scipy.io.wavfile

from musicfpaugment_torch.afp.audfprint import AudfprintPeaks
from musicfpaugment_torch.data import audio_io, mp3_encode, native
from musicfpaugment_torch.data.dataset import load_track
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.testing.parameters import afp_settings
from musicfpaugment_tpu.afp.audfprint import AudfprintPeaks as JAudfprintPeaks
from musicfpaugment_tpu.data import native as jnative

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tone.mp3")
tdv = importlib.import_module("musicfpaugment_torch.afp.dejavu.dejavu")
tfp = importlib.import_module("musicfpaugment_torch.afp.dejavu.fingerprint")
jdv = importlib.import_module("musicfpaugment_tpu.afp.dejavu.dejavu")
jfp = importlib.import_module("musicfpaugment_tpu.afp.dejavu.fingerprint")


@pytest.fixture
def mp3():
    if not native.mp3_available():
        pytest.skip("libmpg123.so.0 cannot be loaded")
    return FIXTURE


@pytest.fixture
def lame():
    if not mp3_encode.available():
        pytest.skip(f"libmp3lame cannot be loaded: {mp3_encode.load_error()}")


def test_build_goes_to_the_port_build_dir_and_is_cached():
    path = native.build()
    assert path.startswith(os.path.join(native.PKG_DIR, "build") + os.sep)
    assert path.endswith("libmfpa_native.so") and os.path.exists(path)
    assert native.build() == path  # the same sources and flags: no rebuild
    assert {os.path.basename(s) for s in native.sources()} == {"wavio.cc", "mp3io.cc", "loader.cc"}
    assert native.available()


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    (tmp_path / "broken.cc").write_text("int main( {\n")
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def test_mp3_decode_is_bit_identical_to_jax(mp3):
    data, sr = native.read_mp3(mp3)
    j_data, j_sr = jnative.read_mp3(mp3)
    assert sr == j_sr == 22050 and data.dtype == np.float32 and data.shape[0] == 1
    np.testing.assert_array_equal(data, j_data)
    via_io, sr2 = audio_io.read_wav(mp3)  # the extension dispatch
    assert sr2 == sr
    np.testing.assert_array_equal(via_io, data)
    assert native.mp3_metadata(mp3) == jnative.mp3_metadata(mp3) == (data.shape[1], sr)
    assert audio_io.wav_metadata(mp3) == (data.shape[1], sr)


@pytest.mark.parametrize("dtype", ["int16", "float32", "int32", "uint8"])
@pytest.mark.parametrize("channels", [1, 2])
def test_native_wav_equals_scipy_wav(tmp_path, dtype, channels):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (1000, channels)).astype(np.float32)
    raw = {
        "int16": (x * 32767).astype(np.int16),
        "float32": x,
        "int32": (x * 2147483000).astype(np.int32),
        "uint8": (x * 127 + 128).astype(np.uint8),
    }[dtype]
    path = str(tmp_path / f"x_{dtype}.wav")
    scipy.io.wavfile.write(path, 11025, raw[:, 0] if channels == 1 else raw)
    got, sr = native.read_wav(path)
    want, sr2 = audio_io.read_wav(path)
    assert sr == sr2 == 11025 and got.shape == want.shape == (channels, 1000)
    np.testing.assert_array_equal(got, want)
    j_got, _ = jnative.read_wav(path)
    np.testing.assert_array_equal(got, j_got)
    assert native.wav_metadata(path) == audio_io.wav_metadata(path) == (1000, 11025)


def test_read_wav_batch_with_a_missing_file(mp3, tmp_path):
    sr = 8000
    wav = (0.5 * np.sin(2 * np.pi * 220.0 * np.arange(sr) / sr)).astype(np.float32)
    wav_path = str(tmp_path / "a.wav")
    scipy.io.wavfile.write(wav_path, sr, (wav * 32767).astype(np.int16))
    paths = [wav_path, mp3, str(tmp_path / "nope.mp3"), str(tmp_path / "nope.wav")]
    for threads in (0, 1, 3):
        results = native.read_wav_batch(paths, num_threads=threads)
        assert len(results) == 4 and results[2] is None and results[3] is None
        np.testing.assert_array_equal(results[0][0], audio_io.read_wav(wav_path)[0])
        np.testing.assert_array_equal(results[1][0], native.read_mp3(mp3)[0])
        assert (results[0][1], results[1][1]) == (sr, 22050)
    j_results = jnative.read_wav_batch(paths)
    np.testing.assert_array_equal(results[1][0], j_results[1][0])
    assert native.read_wav_batch([]) == []
    with pytest.raises(IOError, match="failed"):
        native.read_mp3(str(tmp_path / "nope.mp3"))


def test_encode_decode_round_trip(mp3, lame, tmp_path):
    sr = 22050  # as tests/make_mp3_fixture.py encodes
    x = next(synthetic_clean_batches(1, 3 * sr, sr, seed=3))[0] * 0.8
    path = str(tmp_path / "track.mp3")
    mp3_encode.encode_mp3(x, path, sr)
    y, sr2 = audio_io.read_wav(path)
    assert sr2 == sr and y.shape[0] == 1
    # the decoder's output lags the input by the codec's fixed delay
    lag = int(np.argmax(np.correlate(y[0, : 2 * sr], x[: sr], mode="valid")))
    seg = y[0, lag : lag + 2 * sr]
    assert np.corrcoef(seg, x[: 2 * sr])[0, 1] > 0.99
    # JAX's encoder writes the same bytes, and JAX decodes them alike
    from musicfpaugment_tpu.data import mp3_encode as jmp3_encode

    j_path = str(tmp_path / "track_jax.mp3")
    jmp3_encode.encode_mp3(x, j_path, sr)
    assert open(path, "rb").read() == open(j_path, "rb").read()
    np.testing.assert_array_equal(jnative.read_mp3(path)[0], y)


def test_training_loader_reads_mp3(mp3):
    got = load_track(mp3, 8000)
    data, sr = native.read_mp3(mp3)
    want = audio_io.resample(data[0], sr, 8000)
    np.testing.assert_array_equal(got, (want / np.abs(want).max()).astype(np.float32))


@pytest.fixture(scope="module")
def music_mp3(tmp_path_factory):
    """A 6 s synthetic music track encoded at 22.05 kHz."""
    if not (native.mp3_available() and mp3_encode.available()):
        pytest.skip("libmpg123 or libmp3lame cannot be loaded")
    sr = 22050
    x = next(synthetic_clean_batches(1, 6 * sr, sr, seed=11))[0] * 0.8
    path = str(tmp_path_factory.mktemp("mp3") / "music.mp3")
    mp3_encode.encode_mp3(x, path, sr)
    return path


@pytest.mark.parametrize("which", ["tone", "music"])
def test_audfprint_hashes_of_an_mp3_equal_jax(mp3, music_mp3, which):
    path = mp3 if which == "tone" else music_mp3
    an = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    j_an = JAudfprintPeaks(afp_settings["audfprint"])
    for shifts in (1, 4):
        an.shifts = j_an.shifts = shifts
        hashes = an.wavfile2hashes(path)
        assert len(hashes) >= (1 if which == "tone" else 100)
        np.testing.assert_array_equal(hashes, j_an.wavfile2hashes(path))
    assert an.soundfiledur == pytest.approx(j_an.soundfiledur)


@pytest.mark.parametrize("which", ["tone", "music"])
def test_dejavu_hashes_of_an_mp3_equal_jax(mp3, music_mp3, which):
    path = mp3 if which == "tone" else music_mp3
    channels, fs, file_hash = tdv.read(path, device="cpu")
    j_channels, j_fs, j_hash = jdv.read(path)
    assert fs == j_fs and file_hash == j_hash
    np.testing.assert_array_equal(channels[0], np.asarray(j_channels[0]))
    got = tfp.fingerprint(channels[0], device="cpu")
    want = jfp.fingerprint(np.asarray(j_channels[0]))
    assert len(want) >= (5 if which == "tone" else 100)
    assert sorted(got) == sorted(want)
