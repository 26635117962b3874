"""Input data for the port: TFRecord shards of JPEG frames read into device
batches (``InputReader``), the shard writer, and synthetic batches."""

from x3d_tpu_torch.data.pipeline import InputReader  # noqa: F401
from x3d_tpu_torch.data.synthetic import synthetic_batches  # noqa: F401
from x3d_tpu_torch.data.tfrecords import (  # noqa: F401
    frames_to_sequence_example, write_shard, write_video_array_shards)
