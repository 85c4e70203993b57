__version__ = "0.2.0"

# On-disk format versions (mirrors the reference's versioned codec scheme,
# JVectorFormat.java:31-33 — their v1 added the quantizationType byte).
#   v1: initial format (quantization type byte always present)
#   v2: scalar-quantization container (scalar.jvtpu, type bytes 3-5)
# Old versions stay readable (backward_codecs intent): the committed v1
# fixture under tests/fixtures/bwc_v1_segment is opened by every CI run.
FORMAT_VERSION = 2
MIN_SUPPORTED_FORMAT_VERSION = 1
