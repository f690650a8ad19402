"""Host copy of `srsran_tpu/io/__init__.py`, held to it by `tests/test_torch_stack.py`.

I/Q sample I/O: file capture/replay, network source/sink, bit sources."""

from .filesource import FileSink, FileSource, binsource  # noqa: F401
from .net import NetSink, NetSource  # noqa: F401
from .radio import ChannelMapping, Radio  # noqa: F401
