"""C-API-parity wrappers mirroring the reference's ce_stt_* functions (port
of catears_tpu/runtime/capi.py).

Every entry point returns None / CE_STT_FAILED on error and records the
message, retrievable via ce_stt_last_error(), instead of raising.
`ce_stt_init` takes the Recognizer's `device` (the card unless the CPU is
asked for).
"""

from __future__ import annotations

from typing import Optional

from catears_tpu_torch.io.wav import WaveFormat, read_pcm_header
from catears_tpu_torch.runtime.recognizer import Recognizer, Utterance
from catears_tpu_torch.utils.device import Device
from catears_tpu_torch.utils.errors import last_error, record_error

CE_STT_FAILED = -1


def ce_stt_init(config_file: str,
                device: Device = "cuda") -> Optional[Recognizer]:
    try:
        return Recognizer(config_file, device=device)
    except Exception as e:  # noqa: BLE001 - C-API boundary swallows errors
        record_error(str(e))
        return None


def ce_stt_destroy(recognizer: Recognizer) -> None:
    pass  # lifetime is Python-managed


def ce_utt_init(recognizer: Recognizer,
                fmt: WaveFormat) -> Optional[Utterance]:
    try:
        return recognizer.create_utterance(fmt)
    except Exception as e:  # noqa: BLE001
        record_error(str(e))
        return None


def ce_utt_destroy(utt: Utterance) -> None:
    pass


def ce_stt_process(utt: Utterance, data: bytes) -> int:
    try:
        return utt.process(data)
    except Exception as e:  # noqa: BLE001
        record_error(str(e))
        return CE_STT_FAILED


def ce_stt_end_of_stream(utt: Utterance) -> None:
    try:
        utt.end_of_stream()
    except Exception as e:  # noqa: BLE001
        record_error(str(e))


def ce_read_pcm_header(fd) -> Optional[WaveFormat]:
    try:
        return read_pcm_header(fd)
    except Exception as e:  # noqa: BLE001
        record_error(str(e))
        return None


def ce_stt_last_error() -> str:
    return last_error()
