"""Host C++ helpers, built with g++ at first use (``native.build``)."""
