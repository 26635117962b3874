"""Input data for the port: TFRecord shards of JPEG frames and text lists of
raw videos read into device batches (``InputReader``; ``avi`` and ``video``
read the videos), the shard writer and dataset tools (``tfrecords``), and
synthetic batches."""

from x3d_tpu_torch.data.pipeline import InputReader  # noqa: F401
from x3d_tpu_torch.data.synthetic import synthetic_batches  # noqa: F401
from x3d_tpu_torch.data.tfrecords import (  # noqa: F401
    frames_to_sequence_example, write_shard, write_video_array_shards)
