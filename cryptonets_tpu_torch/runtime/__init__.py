"""Host runtime of the port: the 128-bit-product slot NTT in C++
(`hostcrypto.cpp`), built at first use and bound with ctypes."""
