"""Content-hash checkpoint cache + temp-file lifecycle.

The port's own copy of `synt_isic_tpu/cache.py` (itself the reference
`CacheManager`, `core/cache/cache_manager.py:18-382`): models/temp/metadata
subtree, MD5 content hashing, `cache_model` copying to
`models/<class>_<hash8>.pth`, stale-entry eviction with last-accessed
touch, a temp-file registry, age-based cleanup (models 30 days, temp 24 h),
cache statistics, `clear_all_cache`, and metadata persisted to
`metadata/cache_metadata.json`.

Left out: the JAX package's `cache_converted`/`get_converted`, which keep
the torch->flax-converted parameter arrays as `.npz`. The port loads the
`.pth` state dict natively, so there is nothing converted to cache.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional

MODEL_MAX_AGE_S = 30 * 24 * 3600
TEMP_MAX_AGE_S = 24 * 3600


class CacheManager:
    def __init__(self, cache_dir: str):
        self.cache_dir = Path(cache_dir)
        self.models_dir = self.cache_dir / "models"
        self.temp_dir = self.cache_dir / "temp"
        self.metadata_dir = self.cache_dir / "metadata"
        for d in (self.models_dir, self.temp_dir, self.metadata_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.metadata_file = self.metadata_dir / "cache_metadata.json"
        self.metadata = self._load_metadata()

    # -- metadata store ---------------------------------------------------------
    def _load_metadata(self) -> Dict[str, Any]:
        if self.metadata_file.exists():
            try:
                with open(self.metadata_file, "r", encoding="utf-8") as f:
                    return json.load(f)
            except Exception:
                pass
        return {"models": {}, "temp_files": {}}

    def _save_metadata(self) -> None:
        with open(self.metadata_file, "w", encoding="utf-8") as f:
            json.dump(self.metadata, f, indent=2, ensure_ascii=False)

    # -- hashing -------------------------------------------------------------------
    @staticmethod
    def file_hash(path: str, chunk: int = 1 << 20) -> str:
        md5 = hashlib.md5()
        with open(path, "rb") as f:
            while True:
                block = f.read(chunk)
                if not block:
                    break
                md5.update(block)
        return md5.hexdigest()

    # -- model cache ------------------------------------------------------------------
    def cache_model(self, class_name: str, source_path: str) -> Optional[Path]:
        """Copy a checkpoint into the cache under its content hash."""
        src = Path(source_path)
        if not src.exists():
            return None
        digest = self.file_hash(source_path)
        cached = self.models_dir / f"{class_name}_{digest[:8]}{src.suffix}"
        if not cached.exists():
            shutil.copy2(src, cached)
        self.metadata["models"][class_name] = {
            "cached_path": str(cached),
            "source_path": str(src),
            "hash": digest,
            "size_bytes": src.stat().st_size,
            "cached_at": time.time(),
            "last_accessed": time.time(),
        }
        self._save_metadata()
        return cached

    def get_cached_model(self, class_name: str,
                         expected_source: Optional[str] = None) -> Optional[Path]:
        """Cache-first lookup with stale-entry eviction: if the source file
        changed (different hash), the entry is dropped."""
        entry = self.metadata["models"].get(class_name)
        if not entry:
            return None
        cached = Path(entry["cached_path"])
        if not cached.exists():
            del self.metadata["models"][class_name]
            self._save_metadata()
            return None
        if expected_source and Path(expected_source).exists():
            if self.file_hash(expected_source) != entry["hash"]:
                cached.unlink(missing_ok=True)
                del self.metadata["models"][class_name]
                self._save_metadata()
                return None
        entry["last_accessed"] = time.time()
        self._save_metadata()
        return cached

    # -- temp files ------------------------------------------------------------------------
    def register_temp_file(self, path: str, purpose: str = "") -> None:
        self.metadata["temp_files"][str(path)] = {
            "created_at": time.time(), "purpose": purpose}
        self._save_metadata()

    def cleanup_temp_files(self, max_age_s: float = TEMP_MAX_AGE_S) -> int:
        now = time.time()
        removed = 0
        for path in list(self.metadata["temp_files"]):
            entry = self.metadata["temp_files"][path]
            if now - entry["created_at"] > max_age_s or not Path(path).exists():
                Path(path).unlink(missing_ok=True)
                del self.metadata["temp_files"][path]
                removed += 1
        self._save_metadata()
        return removed

    def cleanup_old_models(self, max_age_s: float = MODEL_MAX_AGE_S) -> int:
        now = time.time()
        removed = 0
        for cls in list(self.metadata["models"]):
            entry = self.metadata["models"][cls]
            if now - entry.get("last_accessed", entry["cached_at"]) > max_age_s:
                Path(entry["cached_path"]).unlink(missing_ok=True)
                del self.metadata["models"][cls]
                removed += 1
        self._save_metadata()
        return removed

    # -- stats / teardown ---------------------------------------------------------------------
    def get_cache_stats(self) -> Dict[str, Any]:
        total = sum(e.get("size_bytes", 0) for e in self.metadata["models"].values())
        return {
            "cached_models": len(self.metadata["models"]),
            "temp_files": len(self.metadata["temp_files"]),
            "total_size_bytes": total,
            "total_size_mb": round(total / (1024 * 1024), 2),
            "cache_dir": str(self.cache_dir),
        }

    def clear_all_cache(self) -> None:
        for d in (self.models_dir, self.temp_dir):
            for p in d.iterdir():
                p.unlink(missing_ok=True)
        self.metadata = {"models": {}, "temp_files": {}}
        self._save_metadata()

    def close(self) -> None:
        self.cleanup_temp_files()
