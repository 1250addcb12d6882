"""Logging, metric streams and step timing."""
