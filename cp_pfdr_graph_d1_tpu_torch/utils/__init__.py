"""Monitoring utilities."""
