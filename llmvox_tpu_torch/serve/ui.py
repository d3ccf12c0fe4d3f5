"""Demo clients for a running server (the reference's ``run_ui.py``).

Counterpart of ``llmvox_tpu/serve/ui.py`` on the port's streaming client
(``serve/client.py::stream_chunks``), with no JAX on the host:

- ``TerminalDemo``: a headless text chat loop: type a prompt, stream the
  reply's audio to a WAV file (and play it through PyAudio when that is
  installed).  Works anywhere.
- ``launch_qt_ui``: a PyQt5 window like the reference's UI: a webcam
  capture thread (OpenCV), an energy-threshold microphone thread, and
  three tabs (text, voice, visual chat).  It needs PyQt5, OpenCV and
  PyAudio, and says so otherwise.

    python -m llmvox_tpu_torch.serve.ui --port 5003 [--save_dir out]
    python -m llmvox_tpu_torch.serve.ui --qt
"""
from __future__ import annotations

import argparse
import base64
import sys
import threading
import time
from typing import Optional

import numpy as np

from llmvox_tpu_torch.serve import client as tts_client
from llmvox_tpu_torch.utils.audio import write_wav

SAMPLE_RATE = 24000


# ---------------------------------------------------------------------------
# Optional audio playback
# ---------------------------------------------------------------------------

class AudioPlayer:
    """Streaming float32 playback via PyAudio, no-op when unavailable."""

    def __init__(self):
        try:
            import pyaudio
            self._pa = pyaudio.PyAudio()
            self._stream = self._pa.open(
                format=pyaudio.paFloat32, channels=1, rate=SAMPLE_RATE,
                output=True)
        except Exception:
            self._pa = None
            self._stream = None

    @property
    def available(self) -> bool:
        return self._stream is not None

    def play(self, chunk: bytes) -> None:
        if self._stream is not None:
            self._stream.write(chunk)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.stop_stream()
            self._stream.close()
            self._pa.terminate()


# ---------------------------------------------------------------------------
# Terminal demo
# ---------------------------------------------------------------------------

class TerminalDemo:
    def __init__(self, host: str = "127.0.0.1", port: int = 5003,
                 save_dir: Optional[str] = None):
        self.host, self.port = host, port
        self.save_dir = save_dir
        self.player = AudioPlayer()

    def chat(self) -> None:
        print(f"LLMVoX demo — server {self.host}:{self.port} "
              f"(playback: {'on' if self.player.available else 'off'})")
        n = 0
        while True:
            try:
                text = input("you> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not text or text in ("exit", "quit"):
                break
            t0 = time.perf_counter()
            buf = bytearray()
            first = None
            for _, chunk in tts_client.stream_chunks(
                    self.host, self.port, "/tts", {"text": text}):
                if first is None:
                    first = time.perf_counter() - t0
                self.player.play(chunk)
                buf.extend(chunk)
            wav = np.frombuffer(bytes(buf), dtype="<f4")
            print(f"  [{len(wav) / SAMPLE_RATE:.1f}s audio, first chunk "
                  f"{(first or 0) * 1000:.0f} ms]")
            if self.save_dir:
                path = f"{self.save_dir}/reply_{n:03d}.wav"
                write_wav(path, wav, SAMPLE_RATE)
                print(f"  saved {path}")
                n += 1
        self.player.close()


# ---------------------------------------------------------------------------
# Microphone VAD (energy threshold, mirrors run_ui.py's MicrophoneListener)
# ---------------------------------------------------------------------------

class MicrophoneListener(threading.Thread):
    """Captures utterances bounded by an energy threshold; calls
    ``on_utterance(float32 mono 16 kHz)`` for each."""

    def __init__(self, on_utterance, threshold: float = 0.01,
                 silence_s: float = 0.8, rate: int = 16000):
        super().__init__(daemon=True)
        self.on_utterance = on_utterance
        self.threshold = threshold
        self.silence_s = silence_s
        self.rate = rate
        self.running = True

    def run(self) -> None:
        import pyaudio
        pa = pyaudio.PyAudio()
        stream = pa.open(format=pyaudio.paInt16, channels=1, rate=self.rate,
                         input=True, frames_per_buffer=1024)
        voiced, silent_chunks = [], 0
        chunk_s = 1024 / self.rate
        while self.running:
            raw = stream.read(1024, exception_on_overflow=False)
            x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
            if np.sqrt(np.mean(x * x)) > self.threshold:
                voiced.append(x)
                silent_chunks = 0
            elif voiced:
                silent_chunks += 1
                voiced.append(x)
                if silent_chunks * chunk_s >= self.silence_s:
                    self.on_utterance(np.concatenate(voiced))
                    voiced, silent_chunks = [], 0
        stream.close()
        pa.terminate()


# ---------------------------------------------------------------------------
# PyQt5 UI (gated)
# ---------------------------------------------------------------------------

def build_qt_window(host: str = "127.0.0.1", port: int = 5003,
                    start_threads: bool = True):
    """Construct the Qt application and its 3-tab window (the reference's
    run_ui.py:253-855).  ``start_threads=False`` skips the webcam/mic
    capture threads so the window can be built headless
    (QT_QPA_PLATFORM=offscreen) for smoke tests.  Returns (app, window).
    """
    try:
        from PyQt5 import QtCore, QtGui, QtWidgets
    except ImportError as e:
        raise RuntimeError(
            "PyQt5 is required for the graphical demo; use TerminalDemo "
            "(python -m llmvox_tpu_torch.serve.ui) in headless "
            "environments"
        ) from e
    import cv2

    player = AudioPlayer()

    class WebcamCapture(QtCore.QThread):
        frame_ready = QtCore.pyqtSignal(object)

        def __init__(self):
            super().__init__()
            self.running = True
            self.latest = None

        def run(self):
            cap = cv2.VideoCapture(0)
            while self.running:
                ok, frame = cap.read()
                if ok:
                    self.latest = frame
                    self.frame_ready.emit(frame)
                self.msleep(33)
            cap.release()

    class ChatWindow(QtWidgets.QMainWindow):
        def __init__(self):
            super().__init__()
            self.setWindowTitle("LLMVoX Voice Chat")
            tabs = QtWidgets.QTabWidget()
            self.setCentralWidget(tabs)
            self.webcam = WebcamCapture()

            # -- text tab --------------------------------------------
            text_tab = QtWidgets.QWidget()
            lay = QtWidgets.QVBoxLayout(text_tab)
            self.text_log = QtWidgets.QTextEdit(readOnly=True)
            self.text_in = QtWidgets.QLineEdit()
            self.text_in.returnPressed.connect(self._send_text)
            lay.addWidget(self.text_log)
            lay.addWidget(self.text_in)
            tabs.addTab(text_tab, "Text Chat")

            # -- voice tab -------------------------------------------
            voice_tab = QtWidgets.QWidget()
            vlay = QtWidgets.QVBoxLayout(voice_tab)
            self.voice_status = QtWidgets.QLabel("listening...")
            vlay.addWidget(self.voice_status)
            tabs.addTab(voice_tab, "Voice Chat")
            self.mic = MicrophoneListener(self._on_utterance)
            if start_threads:
                self.mic.start()

            # -- visual tab ------------------------------------------
            visual_tab = QtWidgets.QWidget()
            vilay = QtWidgets.QVBoxLayout(visual_tab)
            self.cam_label = QtWidgets.QLabel()
            vilay.addWidget(self.cam_label)
            tabs.addTab(visual_tab, "Visual Chat")
            self.webcam.frame_ready.connect(self._show_frame)
            if start_threads:
                self.webcam.start()

        def _show_frame(self, frame):
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            h, w, _ = rgb.shape
            img = QtGui.QImage(rgb.data, w, h, 3 * w,
                               QtGui.QImage.Format_RGB888)
            self.cam_label.setPixmap(QtGui.QPixmap.fromImage(img))

        def _send_text(self):
            text = self.text_in.text().strip()
            if not text:
                return
            self.text_log.append(f"you: {text}")
            self.text_in.clear()
            threading.Thread(target=self._stream_tts, args=(text,),
                             daemon=True).start()

        def _stream_tts(self, text):
            for _, chunk in tts_client.stream_chunks(
                    host, port, "/tts", {"text": text}):
                player.play(chunk)

        def _on_utterance(self, audio16k: np.ndarray):
            pcm16 = (np.clip(audio16k, -1, 1) * 32767).astype("<i2")
            payload = {
                "source_language": "english", "target_language": "english",
                "audio_base64": base64.b64encode(pcm16.tobytes()).decode(),
            }
            frame = self.webcam.latest
            path = "/voicechat"
            if frame is not None:
                ok, jpg = cv2.imencode(".jpg", frame)
                if ok:
                    payload["image_base64"] = base64.b64encode(
                        jpg.tobytes()).decode()
                    path = "/vlmschat"
            for _, chunk in tts_client.stream_chunks(host, port, path,
                                                     payload):
                player.play(chunk)

    app = QtWidgets.QApplication.instance() or QtWidgets.QApplication(
        sys.argv)
    win = ChatWindow()
    return app, win


def launch_qt_ui(host: str = "127.0.0.1", port: int = 5003) -> None:
    app, win = build_qt_window(host, port)
    win.show()
    sys.exit(app.exec_())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="LLMVoX demo client")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5003)
    parser.add_argument("--qt", action="store_true", help="launch PyQt5 UI")
    parser.add_argument("--save_dir", default=None)
    args = parser.parse_args(argv)
    if args.qt:
        launch_qt_ui(args.host, args.port)
    else:
        TerminalDemo(args.host, args.port, args.save_dir).chat()


if __name__ == "__main__":
    main()
