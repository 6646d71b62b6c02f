"""The LineMOD data contract: the index and its C++ parser, the PNG reader,
the host crop and loader, and the device-resident store."""
