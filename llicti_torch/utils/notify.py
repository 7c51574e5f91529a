"""Experiment-completion notifier (reference utils/mailer.py equivalent).

The port's own copy of ``llicti_tpu/utils/notify.py``.

The reference ships an SMTP Mailer that is imported but never invoked
(agents/base.py:7; SURVEY.md §2 row 14).  We provide the same capability
with a pluggable transport: SMTP when configured, else a JSONL event log
under the experiment dir (useful on machines without mail).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass


@dataclass
class Notifier:
    smtp_host: str = ""
    smtp_port: int = 587
    user: str = ""
    password: str = ""
    to_addr: str = ""
    event_log: str = ""

    def send(self, subject: str, body: str) -> bool:
        if self.smtp_host:
            try:
                import smtplib
                from email.message import EmailMessage

                msg = EmailMessage()
                msg["Subject"] = subject
                msg["From"] = self.user
                msg["To"] = self.to_addr
                msg.set_content(body)
                with smtplib.SMTP(self.smtp_host, self.smtp_port) as s:
                    s.starttls()
                    if self.user:
                        s.login(self.user, self.password)
                    s.send_message(msg)
                return True
            except Exception:
                pass  # fall through to the event log
        if self.event_log:
            os.makedirs(os.path.dirname(self.event_log) or ".", exist_ok=True)
            with open(self.event_log, "a") as f:
                f.write(json.dumps({
                    "ts": time.time(), "subject": subject, "body": body,
                }) + "\n")
            return True
        return False
