"""Serve-step builders."""
