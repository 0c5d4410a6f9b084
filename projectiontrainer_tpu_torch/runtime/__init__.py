"""The host-side C++ image pipeline of the input feed (``runtime/native.py``)."""
