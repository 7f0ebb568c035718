"""Configuration and weight conversion helpers."""
