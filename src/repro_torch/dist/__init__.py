"""Distributed runtime: host checkpointing with retention
(`checkpoint`) and elastic mesh replanning (`elastic`)."""
