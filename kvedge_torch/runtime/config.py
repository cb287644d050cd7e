"""The serving knobs the port reads, from the runtime TOML.

The same TOML document as the JAX package's runtime config, with the
same names and defaults, for the subset this slice serves:

    [model]    preset, vocab, d_model, n_heads, n_kv_heads, n_layers, d_ff
    [payload]  kind ("serve"), serving ("paged"), seq (the model's
               max_seq), paged_attention, serving_slots,
               serving_page_size, serving_pages, serving_prefill_chunk,
               serving_window, serving_kv_dtype
    [status]   port, bind

Any other section or key is REFUSED with its name, not ignored: a knob
the port does not implement (speculation, the overlap pipeline, the
prefix cache, ...) would otherwise silently change nothing.
"""

from __future__ import annotations

import dataclasses
import tomllib
from typing import Mapping

from kvedge_torch.models.config import PRESETS, TransformerConfig


class RuntimeConfigError(ValueError):
    pass


_MODEL_KEYS = ("preset", "vocab", "d_model", "n_heads", "n_kv_heads",
               "n_layers", "d_ff")
# TOML key -> ServeConfig field.
_PAYLOAD_KEYS = {
    "kind": "payload",
    "serving": "payload_serving",
    "seq": "max_seq",
    "paged_attention": "payload_paged_attention",
    "serving_slots": "serving_slots",
    "serving_page_size": "serving_page_size",
    "serving_pages": "serving_pages",
    "serving_prefill_chunk": "serving_prefill_chunk",
    "serving_window": "serving_window",
    "serving_kv_dtype": "serving_kv_dtype",
}
_STATUS_KEYS = {"port": "status_port", "bind": "status_bind"}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Validated serving config (the parsed form of the TOML)."""

    preset: str = ""  # "" = "probe"
    vocab: int = 0    # 0 = from the preset, for every shape field
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    n_layers: int = 0
    d_ff: int = 0
    payload: str = "serve"
    payload_serving: str = "paged"
    max_seq: int = 128  # [payload] seq (the reference's train_seq default)
    payload_paged_attention: str = ""  # "" = "auto"
    serving_slots: int = 4
    serving_page_size: int = 16
    serving_pages: int = 0  # 0 = every slot can hold a max_seq request
    serving_prefill_chunk: int = 64
    serving_window: int = 64
    serving_kv_dtype: str = ""
    status_port: int = 8476
    status_bind: str = "0.0.0.0"

    @classmethod
    def parse(cls, text: str) -> "ServeConfig":
        try:
            doc = tomllib.loads(text)
        except tomllib.TOMLDecodeError as e:
            raise RuntimeConfigError(f"invalid TOML: {e}") from e
        return cls.from_mapping(doc)

    @classmethod
    def from_mapping(cls, doc: Mapping) -> "ServeConfig":
        unknown = sorted(set(doc) - {"model", "payload", "status"})
        if unknown:
            raise RuntimeConfigError(
                f"section(s) {unknown} are not read by the PyTorch port "
                "(it reads [model], [payload] and [status] only)"
            )
        fields: dict = {}
        for section, known in (("model", {k: k for k in _MODEL_KEYS}),
                               ("payload", _PAYLOAD_KEYS),
                               ("status", _STATUS_KEYS)):
            table = doc.get(section, {})
            if not isinstance(table, Mapping):
                raise RuntimeConfigError(f"[{section}] must be a table")
            bad = sorted(set(table) - set(known))
            if bad:
                raise RuntimeConfigError(
                    f"[{section}] key(s) {bad} are not supported by the "
                    f"PyTorch port; it reads {sorted(known)}"
                )
            for key, value in table.items():
                fields[known[key]] = value
        cfg = cls(**fields)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        for name in ("vocab", "d_model", "n_heads", "n_kv_heads", "n_layers",
                     "d_ff", "max_seq", "serving_slots", "serving_page_size",
                     "serving_pages", "serving_prefill_chunk",
                     "serving_window", "status_port"):
            value = getattr(self, name)
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value < 0:
                raise RuntimeConfigError(
                    f"{name} must be a non-negative integer, got {value!r}")
        if self.preset not in ("", *PRESETS):
            raise RuntimeConfigError(
                f"[model] preset must be one of {sorted(PRESETS)}, got "
                f"{self.preset!r}")
        if self.payload != "serve":
            raise RuntimeConfigError(
                f"[payload] kind = {self.payload!r}: the PyTorch port runs "
                "the 'serve' payload only")
        if self.payload_serving not in ("", "paged"):
            raise RuntimeConfigError(
                f"[payload] serving = {self.payload_serving!r}: the PyTorch "
                "port serves through the paged backend only")
        if self.payload_paged_attention not in ("", "auto", "kernel",
                                                "gather"):
            raise RuntimeConfigError(
                "[payload] paged_attention must be 'auto', 'kernel' or "
                f"'gather', got {self.payload_paged_attention!r}")
        if self.serving_kv_dtype not in ("", "int8"):
            raise RuntimeConfigError(
                "[payload] serving_kv_dtype must be '' or 'int8', got "
                f"{self.serving_kv_dtype!r}")
        for name in ("serving_slots", "serving_page_size", "serving_window"):
            if getattr(self, name) < 1:
                raise RuntimeConfigError(f"[payload] {name} must be >= 1")
        if self.max_seq < 2:
            raise RuntimeConfigError(
                f"[payload] seq = {self.max_seq} is too small to serve")

    def model_config(self, dtype: str = "bfloat16") -> TransformerConfig:
        """The served model: the preset with explicit fields on top."""
        base = PRESETS[self.preset or "probe"]
        tcfg = TransformerConfig(
            vocab=self.vocab or base["vocab"],
            d_model=self.d_model or base["d_model"],
            n_heads=self.n_heads or base["n_heads"],
            n_kv_heads=self.n_kv_heads or base["n_kv_heads"],
            n_layers=self.n_layers or base["n_layers"],
            d_ff=self.d_ff or base["d_ff"],
            max_seq=self.max_seq,
            dtype=dtype,
            paged_attention=self.payload_paged_attention or "auto",
        )
        try:
            tcfg.validate()
        except ValueError as e:
            raise RuntimeConfigError(
                f"[model] configuration is invalid: {e}") from e
        return tcfg
