"""The wire formats of shuffle files and broadcast blobs: batch serde
and framed, checksummed compression (≙ ``blaze_tpu/io``)."""
