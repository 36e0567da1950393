"""Utilities of the port (PNG encode/decode without Pillow)."""
