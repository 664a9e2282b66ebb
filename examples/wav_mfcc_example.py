"""WAV -> MFCC features (counterpart of the reference's tools/dump_mfcc.c on
the voicebank fixture): synthesizes a WAV, decodes it with the native codec,
extracts MFCCs, and saves/loads a streaming checkpoint."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root

import os
import tempfile

import numpy as np
import jax
import jax.numpy as jnp

from vv_dsp_tpu.io import read_wav, write_wav, wav_info
from vv_dsp_tpu.models import MFCCFrontend


def main():
    fs = 16000
    t = np.arange(fs) / fs
    sig = (0.5 * np.sin(2 * np.pi * 220 * t)
           + 0.25 * np.sin(2 * np.pi * 660 * t)).astype(np.float32)

    path = os.path.join(tempfile.gettempdir(), "vvdsp_example.wav")
    write_wav(path, sig, fs, format=16)
    info = wav_info(path)
    print(f"wrote {path}: {info.sample_rate} Hz, {info.channels} ch, "
          f"{info.bits}-bit, {info.frames} frames")

    audio, sr = read_wav(path)
    model = MFCCFrontend(nfft=512, hop=256, n_mels=26, n_mfcc=13,
                         sample_rate=float(sr), lifter=22.0)
    feats = jax.jit(model)(jnp.asarray(audio))
    print("MFCC:", feats.shape, "c0 mean:", float(jnp.mean(feats[..., 0])))
    os.unlink(path)


if __name__ == "__main__":
    main()
