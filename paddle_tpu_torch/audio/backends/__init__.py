"""audio.backends — audio file IO (reference: audio/backends/ — the
'wave' backend built on the stdlib wave module; soundfile optional)."""
from .wave_backend import AudioInfo, get_current_backend, info, list_available_backends, load, save, set_backend  # noqa: F401,E501

__all__ = ["info", "load", "save", "AudioInfo", "get_current_backend",
           "list_available_backends", "set_backend"]
