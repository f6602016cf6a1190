"""Frame sources and sinks of the port: its own copies of ``tpufg.io``'s
(the live preview, ``--preview``, is ``tpufg_torch.io.preview``)."""

from tpufg_torch.io.sources import (
    FrameSource,
    RawVideoSource,
    SyntheticSource,
    StdinSource,
    Y4MSource,
    open_source,
)
from tpufg_torch.io.sinks import (
    FrameSink,
    NullSink,
    PNGDirSink,
    RawVideoSink,
    Y4MSink,
    open_sink,
)
