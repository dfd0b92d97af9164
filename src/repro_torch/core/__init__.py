"""Federated core of the port: FP8 format, QAT, wire, codecs, engine, simulator."""
