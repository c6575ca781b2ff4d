"""Headless viewer (numpy + cv2, imported lazily)."""
