"""Native (C++) host-side components: the libav video decoder.

``src/video_decoder.cc`` is a copy of the JAX package's
``open_o3_video_tpu/native/src/video_decoder.cc`` (a test holds the two
equal); ``video_decoder`` builds it with g++ at first use and binds it with
ctypes.
"""
