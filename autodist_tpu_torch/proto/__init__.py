"""The port's strategy schema: plain dataclasses, no protobuf runtime."""
