"""Native (C++) host code, built with g++ at first use and loaded via ctypes:
the connected-components labeler and statistics sweep of stage 3, and the
LZW and PackBits TIFF strip decoders of stage 1's reader."""
